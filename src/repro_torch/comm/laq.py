"""LAQ — Lazily Aggregated Quantized gradients (Sun et al., NeurIPS 2019)
— port of ``repro.comm.laq``.

Per-worker round (server mirror q̂_m = ``grad_hat``, worker residual e_m):

  v_m = (∇L_m(θ^k) − q̂_m) + e_m         error-feedback innovation
  p_m = Q_b(v_m)                        per-leaf symmetric b-bit grid,
                                        step = max|v|/(2^{b−1}−1)
  upload iff ‖p_m‖² > RHS               the 15a trigger
  on upload: q̂_m ← q̂_m + p_m, e_m ← v_m − p_m; on skip: unchanged

The fast route is two kernel launches for all workers (absmax sweep, then
the fused quantize/residual/‖p‖² sweep) and writes the payload over the
consumed gradient buffer; off the plane, ``encode`` runs the per-leaf
oracle (the math of ``repro.kernels.lag_trigger.ref``).  The packed wire
format (``pack_codes``/``wire_*``) waits for the device plane.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.comm.base import CommPolicy, CommRound, PolicyState, Pytree
from repro_torch.core import lag
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_unflatten


def _laq_leaf(g, q, e, bits: int):
    """One leaf of the oracle encode → (payload, residual, Σp², step)."""
    qmax = float(2 ** (bits - 1) - 1)
    v = (g.float() - q.float()) + e.float()
    if v.numel() == 0:      # the max-reduction identity, as the plane's
        scale = torch.full((), float("-inf"), device=v.device)
    else:
        scale = torch.amax(torch.abs(v))
    step = scale / qmax
    inv = torch.where(step > 0.0,
                      1.0 / torch.where(step > 0.0, step,
                                        torch.ones_like(step)),
                      torch.zeros_like(step))
    codes = torch.clamp(torch.round(v * inv), -qmax, qmax)
    p = codes * step
    return p, v - p, torch.sum(p * p), step


def laq_encode_oracle(g_new: Pytree, q_hat: Pytree, resid: Pytree,
                      bits: int):
    """Per-leaf LAQ encode → (payload tree, residual tree, ‖payload‖²,
    (num_leaves,) quantizer steps)."""
    g_leaves, tdef = tree_flatten(g_new)
    ps, es, steps = [], [], []
    lhs = torch.zeros((), dtype=torch.float32,
                      device=g_leaves[0].device if g_leaves else None)
    for g, q, e in zip(g_leaves, tree_leaves(q_hat), tree_leaves(resid)):
        p, enew, sq, step = _laq_leaf(g, q, e, bits)
        ps.append(p)
        es.append(enew)
        steps.append(step)
        lhs = lhs + sq
    st = torch.stack(steps) if steps else torch.zeros((0,))
    return (tree_unflatten(tdef, ps), tree_unflatten(tdef, es), lhs, st)


class LAQPolicy(CommPolicy):
    """b-bit quantized lazy uploads with error feedback.  ``grad_hat`` is
    the server mirror q̂_m, ``resid`` the float32 residual e_m."""
    name = "laq"
    state_keys = ("grad_hat", "resid")

    def __init__(self, bits: int = 4, fastpath="auto"):
        super().__init__(fastpath=fastpath)
        if not 2 <= bits <= 16:
            raise ValueError(f"LAQ bits must be in [2, 16], got {bits}")
        self.bits = bits

    def init_state(self, grad0, theta0=None) -> PolicyState:
        return {"grad_hat": grad0, "resid": torch.zeros_like(
            grad0, dtype=torch.float32)}

    def encode(self, ctx: CommRound, st: PolicyState
               ) -> Tuple[Pytree, Dict[str, Any]]:
        if ctx.fast is not None and "payload" in ctx.fast:
            f = ctx.fast
            return f["payload"], {"resid_new": f["resid_new"],
                                  "lhs_sq": f["lhs_sq"],
                                  "wire_steps": f["wire_steps"]}
        payload, resid_new, lhs, steps = laq_encode_oracle(
            ctx.grad_new, st["grad_hat"], st["resid"], self.bits)
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

    def fast_precompute(self, plan, grads, st, *, theta, layout):
        # two launches for all workers; the payload overwrites ``grads``
        payload, resid_new, lhs, steps = plan.laq_encode(
            grads, st["grad_hat"], st["resid"], layout, bits=self.bits,
            payload_out=grads)
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
