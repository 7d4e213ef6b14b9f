"""The dense-upload policies GD, LAG-WK and LAG-PS — port of
``repro.comm.policies``.

All three upload the raw gradient innovation δ∇_m = ∇L_m(θ^k) − ĝ_m; they
differ in the trigger: GD always uploads, LAG-WK uploads iff ‖δ∇_m‖² > RHS
(15a), LAG-PS iff L_m²‖θ̂_m − θ^k‖² > RHS (15b).
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

    def fast_precompute(self, plan, grads, st, *, theta, layout):
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

    def fast_precompute(self, plan, grads, st, *, theta, layout):
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

    def fast_precompute(self, plan, grads, st, *, theta, layout):
        # 15b's drift ‖θ̂_m − θ‖² for every worker; θ is the shared
        # (unstacked) buffer, broadcast inside the kernel
        return {"dtheta_sq": plan.delta_sqnorm(st["theta_hat"], theta,
                                               layout)}
