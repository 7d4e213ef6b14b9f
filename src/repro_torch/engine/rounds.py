"""THE round: encode → trigger → decode → reduce → server step → metrics —
port of ``repro.engine.rounds``.

Operands are the flat buffers of ``repro_torch.fastpath.layout``: the
shared iterate ``theta`` (rows, 128), the workers' gradients ``grads`` (W,
rows, 128) and the policy state in ``lag_state`` (each (W, rows, 128)).

State contract (the trainer's ``lag`` group):

  <policy.state_keys>   per-worker mirror state, (W, rows, 128) float32
  nabla                 aggregate ∇^k = Σ_m ĝ_m, (rows, 128)
  hist                  (D,) iterate-lag ring buffer
  comm_total            () int32 upload counter
  comm_per_worker       (W,) int32 per-worker upload counts
  L_m                   (W,) smoothness (PS-rule policies)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.comm import CommPolicy, CommRound, run_round
from repro_torch.core import lag
from repro_torch.engine.server import ServerOptimizer
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import FlatLayout


def policy_rounds(policy: CommPolicy, lagcfg: lag.LAGConfig,
                  theta: torch.Tensor, grads: torch.Tensor, lag_state: Dict,
                  layout: FlatLayout):
    """Run a policy for every worker → (comm (W,) bool, delta (W, rows,
    128), new policy-state dict).

    Fast route (the policy's plan is active: CUDA tensors, or forced; a
    layout the float32 plane cannot serve then raises): the
    kernel-served quantities come from ONE batched ``fast_precompute``,
    ``encode``/``should_upload`` run once over the stacked buffers, and
    ``fast_decode`` folds the state in place.  ``grads`` is consumed (LAQ
    writes its payload over it).  Plain route (no plane, or an inactive
    one): a loop over workers, each round on per-leaf views of the
    buffers — the oracle, or the per-leaf kernels under
    ``use_pallas_comm`` — and the delta goes over ``grads``, the state
    over its buffers, in place.
    """
    W = grads.shape[0]
    pst = {k: lag_state[k] for k in policy.state_keys}
    L_arr = lag_state["L_m"] if policy.needs_L_m else None
    hist = lag_state["hist"]

    plan = plan_lib.active_plan(policy, grads)
    if plan is not None and not plan.supports(layout):
        # an active plan never steps aside: the rounds would leave the
        # kernels without a word
        raise ValueError(f"fastpath={plan.mode!r} is active for tensors on "
                         f"{grads.device}, but the tree has leaf dtypes the "
                         f"float32 comm plane cannot serve: "
                         f"{sorted({str(d) for d in layout.dtypes})}")
    fast = None
    if plan is not None:
        fast = policy.fast_precompute(plan, grads, pst, theta=theta,
                                      layout=layout)
    if fast is not None:
        ctx = CommRound(theta=theta, grad_new=grads, hist=hist, cfg=lagcfg,
                        L_m=L_arr, fast=fast)
        payload, aux = policy.encode(ctx, pst)
        comm = policy.should_upload(ctx, pst, payload, aux)
        delta, new_pst = policy.fast_decode(plan, pst, payload, aux, comm,
                                            theta=theta, layout=layout)
        return comm, delta, new_pst

    # worker m's round returns new trees; its delta then goes over its
    # consumed gradient row and its state over its own state rows, in
    # place (only worker m reads row m), so no (W, rows, 128) buffer is
    # added: at full width the route has to fit one card
    theta_t = layout.unflatten(theta)
    comms = []
    for m in range(W):
        ctx = CommRound(theta=theta_t, grad_new=layout.unflatten(grads[m]),
                        hist=hist, cfg=lagcfg,
                        L_m=None if L_arr is None else L_arr[m])
        st_m = {k: layout.unflatten(v[m], like=torch.float32)
                for k, v in pst.items()}
        comm_m, delta_m, new_st = run_round(policy, ctx, st_m)
        comms.append(comm_m.reshape(()))
        layout.flatten(delta_m, out=grads[m])
        for k in pst:
            layout.flatten(new_st[k], out=pst[k][m])
        del ctx, st_m, delta_m, new_st
    return torch.stack(comms), grads, pst


def sum_reduce(comm: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Σ over the worker dim, in worker order."""
    out = delta[0].clone()
    for m in range(1, delta.shape[0]):
        out.add_(delta[m])
    return out


def lag_round(policy: CommPolicy, server: ServerOptimizer,
              lagcfg: lag.LAGConfig, *, theta: torch.Tensor,
              layout: FlatLayout, opt_state, lag_state: Dict,
              grads: torch.Tensor, step: int
              ) -> Tuple[torch.Tensor, Optional[object], Dict, Dict]:
    """One full lazy-aggregation round for every worker.  Returns
    ``(theta, opt_state, lag_state, metrics)``; ``theta`` and the state
    buffers are updated in place."""
    comm, delta, new_pst = policy_rounds(policy, lagcfg, theta, grads,
                                         lag_state, layout)
    sum_delta = sum_reduce(comm, delta)
    del delta
    return finish_round(policy, server, lagcfg, theta=theta, layout=layout,
                        opt_state=opt_state, lag_state=lag_state, comm=comm,
                        sum_delta=sum_delta, new_pst=new_pst, step=step)


def finish_round(policy: CommPolicy, server: ServerOptimizer,
                 lagcfg: lag.LAGConfig, *, theta: torch.Tensor,
                 layout: FlatLayout, opt_state, lag_state: Dict,
                 comm: torch.Tensor, sum_delta: torch.Tensor, new_pst: Dict,
                 step: int):
    """The server half of :func:`lag_round`: aggregate recursion, server
    step, history push, counters, metrics."""
    nabla = lag_state["nabla"].add_(sum_delta)       # ∇^k = ∇^{k-1} + Σ δ∇
    del sum_delta
    params = layout.unflatten(theta)
    new_params, new_opt = server.apply(params, opt_state,
                                       layout.unflatten(nabla), step, lagcfg)
    # iterate-lag entry from the ACTUAL movement
    hist_new = lag.hist_push(lag_state["hist"],
                             lag.tree_sqdist(new_params, params))
    layout.flatten(new_params, out=theta)
    del new_params

    comm_i = comm.to(torch.int32)
    n_up = torch.sum(comm_i, dtype=torch.int32)
    new_lag = dict(lag_state, nabla=nabla, hist=hist_new, **new_pst,
                   comm_total=lag_state["comm_total"] + n_up,
                   comm_per_worker=lag_state["comm_per_worker"] + comm_i)
    any_comm = torch.any(comm)
    bytes_per_upload = policy.wire_bytes(params)
    metrics = {
        "comm_mask": comm,
        "comm_this_round": n_up,
        "comm_total": new_lag["comm_total"],
        "wire_bytes_this_round": n_up.to(torch.float32) * bytes_per_upload,
        "wire_bytes_total":
            new_lag["comm_total"].to(torch.float32) * bytes_per_upload,
        "trigger_rhs": lag.trigger_rhs(lag_state["hist"], lagcfg),
        "trigger_rhs_underflow": lag.rhs_underflow(lag_state["hist"],
                                                   lagcfg, step),
        "skipped_round": (~any_comm).to(torch.int32),
    }
    return theta, new_opt, new_lag, metrics
