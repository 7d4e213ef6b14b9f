"""LAQ — Lazily Aggregated Quantized gradients (Sun et al., NeurIPS 2019)
— port of ``repro.comm.laq``.

Per-worker round (server mirror q̂_m = ``grad_hat``, worker residual e_m):

  v_m = (∇L_m(θ^k) − q̂_m) + e_m         error-feedback innovation
  p_m = Q_b(v_m)                        per-leaf symmetric b-bit grid,
                                        step = max|v|/(2^{b−1}−1)
  upload iff ‖p_m‖² > RHS               the 15a trigger
  on upload: q̂_m ← q̂_m + p_m, e_m ← v_m − p_m; on skip: unchanged

The fast route is two kernel launches for all workers (absmax sweep, then
the fused quantize/residual/‖p‖² sweep) and writes the float32 payload
over the consumed gradient buffer when that is float32.  Off the plane, ``encode`` runs the per-leaf
encode of ``repro_torch.kernels.lag_trigger.ops``: the per-leaf kernels
under ``use_pallas`` (two launches per leaf), else the plain version.  The
packed wire format (``pack_codes``/``wire_*``) waits for the device plane.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.comm.base import CommPolicy, CommRound, PolicyState, Pytree
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.kernels.lag_trigger import ops as lag_ops


class LAQPolicy(CommPolicy):
    """b-bit quantized lazy uploads with error feedback.  ``grad_hat`` is
    the server mirror q̂_m, ``resid`` the float32 residual e_m.
    ``use_pallas`` selects the per-leaf encode kernels off the plane."""
    name = "laq"
    state_keys = ("grad_hat", "resid")

    def __init__(self, bits: int = 4, use_pallas: bool = False,
                 sqnorm_fn: Callable[[Pytree], torch.Tensor]
                 = lag.tree_sqnorm, fastpath="auto"):
        super().__init__(sqnorm_fn=sqnorm_fn, fastpath=fastpath)
        if not 2 <= bits <= 16:
            raise ValueError(f"LAQ bits must be in [2, 16], got {bits}")
        self.bits = bits
        self.use_pallas = use_pallas

    def init_state(self, grad0, theta0=None) -> PolicyState:
        return {"grad_hat": grad0, "resid": tree_map(
            lambda g: torch.zeros_like(g, dtype=torch.float32), grad0)}

    def encode(self, ctx: CommRound, st: PolicyState
               ) -> Tuple[Pytree, Dict[str, Any]]:
        if ctx.fast is not None and "payload" in ctx.fast:
            f = ctx.fast
            return f["payload"], {"resid_new": f["resid_new"],
                                  "lhs_sq": f["lhs_sq"],
                                  "wire_steps": f["wire_steps"]}
        payload, resid_new, lhs, steps = lag_ops.laq_encode(
            ctx.grad_new, st["grad_hat"], st["resid"], bits=self.bits,
            use_ref=not self.use_pallas, return_steps=True)
        return payload, {"resid_new": resid_new, "lhs_sq": lhs,
                         "wire_steps": steps}

    def should_upload(self, ctx: CommRound, st: PolicyState, payload: Pytree,
                      aux: Dict[str, Any]) -> torch.Tensor:
        return aux["lhs_sq"] > lag.trigger_rhs(ctx.hist, ctx.cfg)

    def decode(self, ctx: CommRound, st: PolicyState, payload: Pytree,
               aux: Dict[str, Any], comm: torch.Tensor
               ) -> Tuple[Pytree, PolicyState]:
        delta, new_st = super().decode(ctx, st, payload, aux, comm)
        new_st["resid"] = lag.tree_select(comm, aux["resid_new"],
                                          st["resid"])
        return delta, new_st

    def fast_precompute(self, plan, grads, st, *, theta, layout,
                        grad_at_hat=None):
        # two launches for all workers (per part of a mixed tree); the
        # float32 payload overwrites float32 ``grads`` (bfloat16 gradients
        # are half its size: the payload takes a buffer of its own)
        payload, resid_new, lhs, steps = plan.laq_encode(
            grads, st["grad_hat"], st["resid"], layout, bits=self.bits,
            payload_out=tree_map(
                lambda g: g if g.dtype == torch.float32 else None, grads))
        return {"payload": payload, "resid_new": resid_new, "lhs_sq": lhs,
                "wire_steps": steps}

    def fast_decode(self, plan, st: PolicyState, payload, aux, comm, *,
                    theta, layout):
        delta, new_st = super().fast_decode(plan, st, payload, aux, comm,
                                            theta=theta, layout=layout)
        # the residual advances by an exact SELECT, in place
        new_st["resid"] = plan.masked_select(aux["resid_new"], st["resid"],
                                             comm, out=st["resid"])
        return delta, new_st

    def wire_bytes(self, grad_like: Pytree) -> float:
        """b bits per coordinate + one float32 scale per leaf."""
        return float(sum(l.numel() * self.bits / 8.0 + 4.0
                         for l in tree_leaves(grad_like)))
