"""THE round: encode → trigger → decode → reduce → server step → metrics —
port of ``repro.engine.rounds``.

Operands are the flat buffers of ``repro_torch.fastpath.layout``: the
shared iterate ``theta`` (rows, 128), the workers' gradients ``grads`` (W,
rows, 128) and the policy state in ``lag_state`` (each (W, rows, 128)).

State contract (the trainer's ``lag`` group):

  <policy.state_keys>   per-worker mirror state, (W, rows, 128), each key
                        in its own dtype: the layout's for ``grad_hat``
                        and ``theta_hat``, float32 for LAQ's ``resid``
  nabla                 aggregate ∇^k = Σ_m ĝ_m, (rows, 128)
  hist                  (D,) iterate-lag ring buffer
  comm_total            () int32 upload counter
  comm_per_worker       (W,) int32 per-worker upload counts
  L_m                   (W,) smoothness (PS-rule policies)
  rounds_skipped        optional () int32, advanced when no worker uploads
                        (the pod topology's all-quiet counter)

A tree of bfloat16 and float32 leaves (``fastpath.layout.MixedLayout``)
holds every buffer above as a ``Parts`` pair: the plane runs each op per
part, the plain route unflattens and flattens each worker's row of both
parts, and the worker sum, ∇'s update and the server step run per part.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.comm import CommPolicy, CommRound
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.engine.server import ServerOptimizer
from repro_torch.fastpath import plan as plan_lib
from repro_torch.fastpath.layout import (Layout, buffer_dtype, dtype_of,
                                         like_parts, parts_of, row)


def _take_stacked(grad_at_hat: Optional[List[torch.Tensor]]
                  ) -> Optional[torch.Tensor]:
    """The fast route's ∇ℓ_m(θ̂_m): the one stacked (W, rows, 128) buffer,
    taken out of the caller's list."""
    if grad_at_hat is None:
        return None
    if len(grad_at_hat) != 1 or any(t.dim() != 3
                                    for t in parts_of(grad_at_hat[0])):
        raise ValueError("on the batched plane grad_at_hat must be [one "
                         "stacked (W, rows, 128) buffer], got "
                         f"{[tuple(_first(t).shape) for t in grad_at_hat]}")
    return grad_at_hat.pop()


def _take_rows(grad_at_hat: Optional[List[torch.Tensor]], W: int
               ) -> Optional[List[torch.Tensor]]:
    """The plain route's ∇ℓ_m(θ̂_m), one (rows, 128) buffer per worker,
    taken out of the caller's list."""
    if grad_at_hat is None:
        return None
    if len(grad_at_hat) != W or any(_first(t).dim() != 2
                                    for t in grad_at_hat):
        raise ValueError(f"on the plain route grad_at_hat must be {W} "
                         f"(rows, 128) buffers, got "
                         f"{[tuple(_first(t).shape) for t in grad_at_hat]}")
    rows = list(grad_at_hat)
    grad_at_hat.clear()
    return rows


def _first(buf) -> torch.Tensor:
    """A buffer's first (or only) part: its worker count and device."""
    return parts_of(buf)[0]


def policy_rounds(policy: CommPolicy, lagcfg: lag.LAGConfig,
                  theta, grads, lag_state: Dict, layout: Layout,
                  grad_at_hat: Optional[List[torch.Tensor]] = None,
                  step: Optional[int] = None, draw: Optional[int] = None,
                  theta_view: Optional[torch.Tensor] = None,
                  worker_offset: int = 0, wire_layout=None):
    """Run a policy for every worker → (comm (W,) bool, delta (W, rows,
    128), new policy-state dict).

    ``worker_offset`` shifts the worker ids: the device plane
    (``repro_torch.devrun``) runs this function on each rank at local W = 1
    and passes the rank, so worker m sees the id it has in the in-process
    run (a cyclic schedule's round robin, a sampled schedule's host draw
    compared with it).  ``wire_layout`` (the payload's ``FlatLayout``)
    makes the return a 4-tuple ``(comm, delta, new_pst, wire)``, ``wire``
    the policy's collective wire dict (``policy.wire_pack``) of this
    round's masked payload: what the device plane gathers across ranks.

    ``theta_view`` (W, rows, 128) is the bounded-staleness hook: each
    worker's own iterate θ^{k−s_m} (the async topology's ring; a ``Parts``
    of stacked views for a pair), against which the triggers and the θ̂
    refresh are evaluated — on the plane the kernels take the stacked
    operand of each part, on the plain route worker m's ``CommRound.theta``
    is row m of each part.  None: every worker sees ``theta``.

    Every ``CommRound`` carries the round index ``step`` (``k``), the
    worker id (the (W,) ids on the device on the fast route, ``m`` on the
    plain route) and a sampled schedule's ``draw`` for this round.
    ``grad_at_hat`` (LASG-WK's ∇ℓ_m(θ̂_m)) is a list the round CONSUMES, so
    that each buffer is freed as soon as it has been read: on the fast
    route ``[stacked (W, rows, 128)]``, dropped once ``fast_precompute``
    has read it; on the plain route W ``(rows, 128)`` rows, row m dropped
    once worker m's trigger has read it.

    Fast route (the policy's plan is active: CUDA tensors, or forced; a
    layout the float32 plane cannot serve then raises): the
    kernel-served quantities come from ONE batched ``fast_precompute``,
    ``encode``/``should_upload`` run once over the stacked buffers, and
    ``fast_decode`` folds the state in place.  ``grads`` is consumed (LAQ
    writes its payload over it).  Plain route (no plane, an inactive one,
    or a policy that opts out): a loop over workers, each round on
    per-leaf views of the buffers — the oracle, or the per-leaf kernels
    under ``use_pallas_comm`` — and the delta goes over ``grads`` (into a
    buffer of its own when its dtype differs), the state over its
    buffers, in place.
    """
    W = _first(grads).shape[0]
    pst = {k: lag_state[k] for k in policy.state_keys}
    L_arr = lag_state["L_m"] if policy.needs_L_m else None
    hist = lag_state["hist"]

    if theta_view is not None and [t.shape for t in parts_of(theta_view)] \
            != [g.shape for g in parts_of(grads)]:
        raise ValueError(f"theta_view must be the stacked (W, rows, 128) "
                         f"view {[tuple(g.shape) for g in parts_of(grads)]}"
                         f", got "
                         f"{[tuple(t.shape) for t in parts_of(theta_view)]}")
    theta_arg = theta if theta_view is None else theta_view
    plan = plan_lib.active_plan(policy, grads)
    if plan is not None and not plan.supports(layout):
        # an active plan never steps aside: the rounds would leave the
        # kernels without a word
        raise ValueError(f"fastpath={plan.mode!r} is active for tensors on "
                         f"{_first(grads).device}, but the tree has leaf "
                         f"dtypes the "
                         f"float32 comm plane cannot serve: "
                         f"{sorted({str(d) for d in layout.dtypes})}")
    fast = None
    if plan is not None:
        gah = _take_stacked(grad_at_hat)
        fast = policy.fast_precompute(plan, grads, pst, theta=theta_arg,
                                      layout=layout, grad_at_hat=gah)
        del gah            # read by the precompute: free it before encode
    if fast is not None:
        ctx = CommRound(theta=theta_arg, grad_new=grads, hist=hist,
                        cfg=lagcfg, L_m=L_arr, fast=fast, k=step, draw=draw,
                        worker_id=worker_offset + torch.arange(
                            W, dtype=torch.int32,
                            device=_first(grads).device))
        payload, aux = policy.encode(ctx, pst)
        comm = policy.should_upload(ctx, pst, payload, aux)
        delta, new_pst = policy.fast_decode(plan, pst, payload, aux, comm,
                                            theta=theta_arg, layout=layout)
        if wire_layout is None:
            return comm, delta, new_pst
        # the payload buffer is the masked delta now: it is packed as is
        del payload
        return comm, delta, new_pst, policy.wire_pack(wire_layout, delta,
                                                      aux, comm)

    # worker m's round returns new trees; its delta then goes over its
    # consumed gradient row and its state over its own state rows, in
    # place (only worker m reads row m), so no (W, rows, 128) buffer is
    # added: at full width the route has to fit one card.  A delta part
    # whose dtype is not the gradients' (LAQ's float32 payload of a float64
    # tree, or of a bfloat16 part) gets a buffer of its own, so that the
    # worker sum adds in the payload's dtype, as the reference's does
    gah_rows = _take_rows(grad_at_hat, W)
    theta_t = layout.unflatten(theta)
    comms, wire_aux = [], []
    delta = grads
    for m in range(W):
        if theta_view is not None:
            theta_t = layout.unflatten(row(theta_view, m))
        ctx = CommRound(theta=theta_t,
                        grad_new=layout.unflatten(row(grads, m)),
                        hist=hist, cfg=lagcfg,
                        L_m=None if L_arr is None else L_arr[m],
                        grad_at_hat=None if gah_rows is None
                        else layout.unflatten(gah_rows[m]),
                        k=step, worker_id=worker_offset + m, draw=draw)
        st_m = {k: layout.unflatten(row(v, m), like=dtype_of(v))
                for k, v in pst.items()}
        # encode → trigger → decode, worker m's ∇ℓ_m(θ̂_m) freed once its
        # trigger has read it
        payload, aux = policy.encode(ctx, st_m)
        comm_m = policy.should_upload(ctx, st_m, payload, aux)
        if gah_rows is not None:
            ctx.grad_at_hat = gah_rows[m] = None
        delta_m, new_st = policy.decode(ctx, st_m, payload, aux, comm_m)
        comms.append(comm_m.reshape(()))
        if wire_layout is not None:
            # what the wire needs of the encode besides the payload (LAQ's
            # quantizer steps), kept past the worker's round
            wire_aux.append({k: v for k, v in aux.items()
                             if k.startswith("wire_")})
        if m == 0:
            dts = [buffer_dtype(l.dtype for l in ls)
                   for ls in layout.split(tree_leaves(delta_m))]
            delta = like_parts(grads, [
                g if dt == g.dtype else torch.zeros(g.shape, dtype=dt,
                                                    device=g.device)
                for g, dt in zip(parts_of(grads), dts)])
        layout.flatten(delta_m, out=row(delta, m))
        for k in pst:
            layout.flatten(new_st[k], out=row(pst[k], m))
        del ctx, st_m, payload, aux, delta_m, new_st
    comm = torch.stack(comms)
    if wire_layout is None:
        return comm, delta, pst
    aux = {k: torch.stack([a[k] for a in wire_aux]) for k in wire_aux[0]}
    return comm, delta, pst, policy.wire_pack(wire_layout, delta, aux, comm)


def _worker_sum(delta: torch.Tensor) -> torch.Tensor:
    acc = lag.acc_dtype(delta.dtype) if delta.shape[0] > 2 else delta.dtype
    out = delta[0].to(acc, copy=True)
    for m in range(1, delta.shape[0]):
        out.add_(delta[m])
    return out.to(delta.dtype)


def sum_reduce(comm: torch.Tensor, delta):
    """Σ over the worker dim, in worker order (per part of a pair).  A
    bfloat16 or float16 delta of more than two workers is summed in float32
    and rounded once, as XLA reduces a 2-byte array (two workers' sum is
    one rounding either way, so it takes no float32 buffer)."""
    return tree_map(_worker_sum, delta)


def lag_round(policy: CommPolicy, server: ServerOptimizer,
              lagcfg: lag.LAGConfig, *, theta, layout: Layout, opt_state,
              lag_state: Dict, grads, step: int,
              grad_at_hat: Optional[List[torch.Tensor]] = None,
              draw: Optional[int] = None,
              reduce_fn: Optional[Callable] = None,
              theta_view: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[object], Dict, Dict]:
    """One full lazy-aggregation round for every worker.  Returns
    ``(theta, opt_state, lag_state, metrics)``; ``theta`` and the state
    buffers are updated in place.  ``grad_at_hat``, ``draw`` and
    ``theta_view`` as in :func:`policy_rounds`; ``reduce_fn(comm, delta)
    → Σ δ∇`` is the topology's reduction (the pod topology skips it on a
    quiet round), :func:`sum_reduce` by default.  The server step, ∇ and
    the iterate-lag history stay on the server's shared θ."""
    comm, delta, new_pst = policy_rounds(policy, lagcfg, theta, grads,
                                         lag_state, layout,
                                         grad_at_hat=grad_at_hat, step=step,
                                         draw=draw, theta_view=theta_view)
    sums = [(reduce_fn or sum_reduce)(comm, delta)]
    del delta
    # hand finish_round the only reference to Σ δ∇, so that it is freed
    # once ∇ has absorbed it, before the server step's temporaries
    return finish_round(policy, server, lagcfg, theta=theta, layout=layout,
                        opt_state=opt_state, lag_state=lag_state, comm=comm,
                        sum_delta=sums.pop(), new_pst=new_pst, step=step)


def finish_round(policy: CommPolicy, server: ServerOptimizer,
                 lagcfg: lag.LAGConfig, *, theta, layout: Layout, opt_state,
                 lag_state: Dict, comm: torch.Tensor, sum_delta,
                 new_pst: Dict,
                 step: int, index: Optional[torch.Tensor] = None,
                 rows=None):
    """The server half of :func:`lag_round`: aggregate recursion, server
    step (``opt_state`` is the server's flat state, None for a stateless
    one), history push, counters, metrics.  ``index`` maps each mask slot
    to its row of ``comm_per_worker`` when the two differ — the fleet's
    (k,) cohort mask against its per-client (N,) counter.

    ``rows`` (the row-sharded trainer's ``dist.row_shards.RowShardComm``):
    ``sum_delta`` and ∇ are this rank's rows; the server steps this rank's
    rows of θ and of its state from them (every server is elementwise),
    and the rows are gathered back into the replicated θ and state.  The
    history's ‖θ^{k+1} − θ^k‖² is then summed leaf by leaf over the whole
    replicated θ, on every rank alike, so it is bitwise the one-rank
    trainer's; masks and counters come out the same on every rank."""
    # ∇^k = ∇^{k-1} + Σ δ∇
    nabla = tree_map(lambda n, s: n.add_(s), lag_state["nabla"], sum_delta)
    del sum_delta
    # every server is elementwise: it steps the flat buffers (one-leaf
    # trees; the zero padding stays zero) and keeps its state flat
    if rows is None:
        new_theta, new_opt = server.apply(theta, opt_state, nabla, step,
                                          lagcfg)
    else:
        new_theta, new_opt = rows.server_step(server, theta, opt_state,
                                              nabla, step, lagcfg)
    params = layout.unflatten(theta)
    # iterate-lag entry from the ACTUAL movement, summed leaf by leaf
    hist_new = lag.hist_push(lag_state["hist"], lag.tree_sqdist(
        layout.unflatten(new_theta), params))
    tree_map(lambda t, n: t.copy_(n), theta, new_theta)
    del new_theta

    comm_i = comm.to(torch.int32)
    n_up = torch.sum(comm_i, dtype=torch.int32)
    per_worker = lag_state["comm_per_worker"] + comm_i if index is None \
        else lag_state["comm_per_worker"].index_add(0, index, comm_i)
    new_lag = dict(lag_state, nabla=nabla, hist=hist_new, **new_pst,
                   comm_total=lag_state["comm_total"] + n_up,
                   comm_per_worker=per_worker)
    any_comm = torch.any(comm)
    if "rounds_skipped" in lag_state:
        new_lag["rounds_skipped"] = lag_state["rounds_skipped"] \
            + (~any_comm).to(torch.int32)
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
