"""The dense-upload policies GD, LAG-WK, LAG-PS and LASG-WK — port of
``repro.comm.policies``.

All four upload the raw gradient innovation δ∇_m = ∇L_m(θ^k) − ĝ_m; they
differ in the trigger: GD always uploads, LAG-WK uploads iff ‖δ∇_m‖² > RHS
(15a), LAG-PS iff L_m²‖θ̂_m − θ^k‖² > RHS (15b), LASG-WK iff
‖∇ℓ_m(θ^k; ξ^k) − ∇ℓ_m(θ̂_m; ξ^k)‖² > RHS (Chen et al. 2020: both
gradients on the current sample).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.comm.base import CommPolicy, CommRound, PolicyState, Pytree
from repro_torch.core import lag


class GDPolicy(CommPolicy):
    """Every worker uploads every round — the synchronous baseline."""
    name = "gd"

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        return torch.ones((), dtype=torch.bool, device=ctx.hist.device)

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        # explicit opt-out: no trigger reduction or encode sweep to serve
        return None


class LAGWKPolicy(CommPolicy):
    """LAG with the worker-side trigger (15a)."""
    name = "lag-wk"

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        if ctx.fast is not None and "lhs_sq" in ctx.fast:
            lhs = ctx.fast["lhs_sq"]      # one batched launch, all workers
        else:
            lhs = self.sqnorm_fn(payload)
        return lhs > lag.trigger_rhs(ctx.hist, ctx.cfg)

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        return {"lhs_sq": plan.delta_sqnorm(grads, st["grad_hat"], layout)}


class LAGPSPolicy(CommPolicy):
    """LAG with the server-side trigger (15b): decided from the iterate
    drift ‖θ̂_m − θ^k‖² and a smoothness bound L_m."""
    name = "lag-ps"
    state_keys = ("grad_hat", "theta_hat")
    needs_theta_hat = True
    needs_L_m = True

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        if ctx.L_m is None:
            raise ValueError("LAG-PS requires per-worker smoothness L_m")
        if ctx.fast is not None and "dtheta_sq" in ctx.fast:
            lhs = (ctx.L_m.to(torch.float32) ** 2) * ctx.fast["dtheta_sq"]
            return lhs > lag.trigger_rhs(ctx.hist, ctx.cfg)
        return lag.ps_communicate(ctx.theta, st["theta_hat"], ctx.L_m,
                                  ctx.hist, ctx.cfg, sqnorm_fn=self.sqnorm_fn)

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        # 15b's drift ‖θ̂_m − θ‖² for every worker; θ is the shared
        # (unstacked) buffer, broadcast inside the kernel
        return {"dtheta_sq": plan.delta_sqnorm(st["theta_hat"], theta,
                                               layout)}


class LASGWKPolicy(CommPolicy):
    """LASG-WK: the worker trigger on stochastic gradients.  LAG-WK's LHS
    ‖∇ℓ(θ^k; ξ^k) − ĝ_m‖² never shrinks under minibatch noise (ĝ_m is from
    an old sample); LASG-WK differences two gradients on the SAME sample —
    the fresh one and ∇ℓ_m(θ̂_m; ξ^k) at the worker's last-upload iterate θ̂_m
    (the trainer's second backward pass, ``needs_grad_at_hat``).  The upload
    is still the dense innovation against ĝ_m, and θ̂_m ← θ^k on upload."""
    name = "lasg-wk"
    state_keys = ("grad_hat", "theta_hat")
    needs_theta_hat = True
    needs_grad_at_hat = True

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        if ctx.fast is not None and "lhs_sq" in ctx.fast:
            return ctx.fast["lhs_sq"] > lag.trigger_rhs(ctx.hist, ctx.cfg)
        if ctx.grad_at_hat is None:
            raise ValueError("LASG-WK requires grad_at_hat (the trainer must "
                             "evaluate ∇ℓ_m(θ̂_m) on the current sample)")
        lhs = self.sqnorm_fn(lag.tree_sub(ctx.grad_new, ctx.grad_at_hat))
        return lhs > lag.trigger_rhs(ctx.hist, ctx.cfg)

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        if grad_at_hat is None:
            raise ValueError("LASG-WK requires grad_at_hat (the trainer must "
                             "evaluate ∇ℓ_m(θ̂_m) on the current sample)")
        # the correlated stochastic trigger ‖∇ℓ(θ^k;ξ) − ∇ℓ(θ̂;ξ)‖², one
        # launch for all workers; θ̂ is folded by the base fast_decode
        return {"lhs_sq": plan.delta_sqnorm(grads, grad_at_hat, layout)}
