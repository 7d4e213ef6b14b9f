"""Schedules as communication policies — port of ``repro.comm.schedule``.

The IAG baselines (cyclic / importance-sampled incremental aggregated
gradient) decide WHO uploads by a round-robin or a draw, not by the
gradient innovation.  ``ScheduledPolicy`` wraps any payload policy and
replaces only ``should_upload`` with the schedule's mask, so the payload
and state mechanics stay the inner policy's (``"cyc-laq@8"`` is cyclic LAQ).

Schedules read the round context the trainer fills in: ``ctx.k`` (the round
index), ``ctx.worker_id`` and, for a sampled schedule, ``ctx.draw``.

The reference draws num-IAG's worker with ``jax.random.choice`` from a key
folded from (seed, round), which PyTorch cannot reproduce.  Here the draw
is :meth:`SampledSchedule.draw`: an injectable ``draw(step) → int``, or by
default a host ``torch.Generator`` seeded from (seed, step) — deterministic
in the round counter, with no RNG state to checkpoint, as the reference's.
The trainer draws once per round and every worker compares the same draw
with its own id, so exactly one worker uploads.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comm.base import CommPolicy, CommRound, PolicyState, Pytree


def _is_worker(ctx: CommRound, m) -> torch.Tensor:
    """``ctx.worker_id == m``: (W,) on the fast route, () on the plain."""
    wid = ctx.worker_id
    if isinstance(wid, torch.Tensor):
        return wid == m
    return torch.tensor(wid == m, device=ctx.hist.device)


class Schedule:
    """WHO uploads at round k — independent of the gradients."""
    name: str = "schedule"
    stochastic: bool = False    # True ⇒ the trainer must supply ctx.draw

    def mask(self, ctx: CommRound) -> torch.Tensor:
        """bool: does worker ``ctx.worker_id`` upload at round ``ctx.k``?"""
        raise NotImplementedError


class CyclicSchedule(Schedule):
    """Round-robin: worker ``k mod M`` uploads at round k (cyc-IAG)."""
    name = "cyc"

    def mask(self, ctx: CommRound) -> torch.Tensor:
        if ctx.k is None or ctx.worker_id is None:
            raise ValueError("CyclicSchedule needs ctx.k and ctx.worker_id "
                             "(the trainer must pass the round index and "
                             "the worker ids)")
        return _is_worker(ctx, ctx.k % ctx.cfg.num_workers)


class SampledSchedule(Schedule):
    """One worker per round, drawn from ``probs`` (num-IAG: p ∝ L_m;
    uniform when None).  ``draw`` (``step → worker``) replaces the default
    host draw — the parity tests inject the reference's draws."""
    name = "num"
    stochastic = True

    def __init__(self, probs: Optional[Sequence[float]] = None,
                 draw: Optional[Callable[[int], int]] = None):
        self.probs = None if probs is None else torch.as_tensor(
            probs, dtype=torch.float64)
        self._draw = draw

    def draw(self, step: int, num_workers: int, seed: int = 0) -> int:
        """The worker that uploads at round ``step``: the same for the same
        (seed, step), never one whose probability is 0."""
        if self._draw is not None:
            return int(self._draw(step))
        p = torch.ones(num_workers, dtype=torch.float64) \
            if self.probs is None else self.probs
        if p.shape != (num_workers,):
            raise ValueError(f"probs has shape {tuple(p.shape)}, want "
                             f"({num_workers},)")
        gen = torch.Generator()
        gen.manual_seed(int(np.random.SeedSequence(
            [seed, step]).generate_state(1)[0]))
        return int(torch.multinomial(p, 1, generator=gen))

    def mask(self, ctx: CommRound) -> torch.Tensor:
        if ctx.draw is None or ctx.worker_id is None:
            raise ValueError("SampledSchedule needs ctx.draw and "
                             "ctx.worker_id (the trainer must draw once per "
                             "round and pass the worker ids)")
        return _is_worker(ctx, ctx.draw)


class ScheduledPolicy(CommPolicy):
    """Any payload policy under a schedule-driven (non-triggered) mask.

    Encode/decode/wire_bytes/state (and the fast route) are delegated
    verbatim to ``inner``, so Σ_m ĝ_m = ∇^k holds as for the wrapped
    policy; only the upload decision is replaced.  A GD payload (cyc-IAG,
    num-IAG) therefore opts out of the plane, as in the reference.
    """

    def __init__(self, inner: CommPolicy, schedule: Schedule):
        super().__init__(sqnorm_fn=inner.sqnorm_fn, fastpath=inner.fastpath)
        self.inner = inner
        self.schedule = schedule
        self.name = f"{schedule.name}-{inner.name}"
        # the inner policy's contract with the trainer, and the schedule's
        self.state_keys = inner.state_keys
        self.needs_theta_hat = inner.needs_theta_hat
        self.needs_L_m = inner.needs_L_m
        self.needs_grad_at_hat = inner.needs_grad_at_hat
        self.needs_rng = schedule.stochastic

    def draw(self, step: int, num_workers: int, seed: int = 0) -> int:
        """The sampled schedule's draw for round ``step``."""
        return self.schedule.draw(step, num_workers, seed)

    def init_state(self, grad0, theta0=None) -> PolicyState:
        return self.inner.init_state(grad0, theta0)

    def encode(self, ctx: CommRound, st: PolicyState
               ) -> Tuple[Pytree, Dict[str, Any]]:
        return self.inner.encode(ctx, st)

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        return self.schedule.mask(ctx)

    def decode(self, ctx: CommRound, st: PolicyState, payload: Pytree,
               aux: Dict[str, Any], comm: torch.Tensor
               ) -> Tuple[Pytree, PolicyState]:
        return self.inner.decode(ctx, st, payload, aux, comm)

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        return self.inner.fast_precompute(plan, grads, st, theta=theta,
                                          layout=layout,
                                          grad_at_hat=grad_at_hat)

    def fast_decode(self, plan, st, payload, aux, comm, *, theta, layout):
        return self.inner.fast_decode(plan, st, payload, aux, comm,
                                      theta=theta, layout=layout)

    def wire_bytes(self, grad_like: Pytree) -> float:
        return self.inner.wire_bytes(grad_like)

    def wire_pack(self, layout, payload, aux: Dict[str, Any],
                  comm: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.inner.wire_pack(layout, payload, aux, comm)

    def wire_unpack(self, layout, wire: Dict[str, torch.Tensor], *,
                    rows=None, device=None) -> torch.Tensor:
        return self.inner.wire_unpack(layout, wire, rows=rows, device=device)

    def wire_slot_bytes(self, layout) -> Dict[str, int]:
        return self.inner.wire_slot_bytes(layout)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ScheduledPolicy({self.inner!r}, "
                f"schedule={self.schedule.name!r})")
