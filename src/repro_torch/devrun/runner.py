"""Device execution plane: one lazy worker PER RANK — port of
``repro.devrun.runner``.

Every in-process topology (``repro_torch.engine.topology``) keeps its
workers as a leading dim of one process's buffers, and its "collective" is
a sum no link has to carry.  Here the workers become real: worker m is
rank m of a ``torch.distributed`` group of D ranks (topology spec
``devices:D``), holding the shared state replicated (θ, ∇, the history,
the server's state, the counters) and its own worker's mirror state (ĝ_m,
θ̂_m, LAQ's residual e_m) as (1, rows, 128) buffers.  The masked deltas
cross between ranks as each policy's PACKED wire tensors
(``repro_torch.comm.CommPolicy.wire_pack``: LAQ moves b-bit codes and
per-leaf quantizer steps, 8× fewer bytes than the float32 payload at
b = 4).

A round on each rank:

  1. the rank's gradient on its batch shard (rows m·B/D:(m+1)·B/D), and
     LASG-WK's second pass at θ̂_m;
  2. the UNCHANGED ``engine.rounds.policy_rounds`` at local W = 1 with
     ``worker_offset = rank``, so worker m has the id (and a sampled
     schedule's host draw the outcome) it has in the in-process run;
     kernels 1–4 run here on the plane, kernels 8–12 on the legacy route;
  3. the (D,) trigger mask and the D losses gathered, one collective each;
     ``any(mask)`` read on the host — one sync a round, as ``PodMesh``;
  4. only when some worker fired, the wire tensors gathered and unpacked
     and summed in worker order — the in-process ``sum_reduce``, since
     the pack/unpack round trip is exact; an all-quiet round moves
     the mask and the losses alone;
  5. ``engine.rounds.finish_round`` replicated on every rank.

So ``devices:D`` is bitwise ``shards:D`` (masks, θ, ĝ, counters) where
each rank's backward pass is bitwise the in-process worker's, which holds
for the same shapes on the same kind of device.

Backends: ``nccl`` when every rank owns a card (rank r on card r mod N);
``gloo`` when asked for: on the CPU, or ranks sharing a card, each
computing on it while the wire goes through host memory (staged
explicitly and counted: ``repro_torch.dist.collectives``).  Deliberate
differences from the reference: there is no fallback — the reference runs
its vmapped trainer on a process with fewer devices than workers, the port
raises by name on a world size other than D (and on ``nccl`` with two ranks
on one card, before NCCL's own error); the host reads the mask every round
(the reference's ``lax.cond`` stays on the device); and the losses are
gathered beside the mask (the reference all-reduces their mean).  A
bfloat16 or float16 parameter tree is refused: the reference's device step
does not train one (its float32 payload promotes the parameters after round
0 and its next round fails to trace), so it defines no 2-byte device round.
"""
from __future__ import annotations

import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import store
from repro_torch.dist import collectives
from repro_torch.dist import lag_trainer
from repro_torch.engine import rounds as engine_rounds
from repro_torch.engine import topology as topo_lib
from repro_torch.fastpath.layout import HALF_DTYPES
from repro_torch.models.common import ModelConfig

#: rows of the flat buffer unpacked and added at a time when the wire is
#: summed: 2^16 rows, 32 MiB of float32
SUM_ROWS = 1 << 16

BACKENDS = ("nccl", "gloo")

_LAUNCHER = ("launch the ranks with `python -m repro_torch.launch.train "
             "--topology devices:D` (it spawns D ranks, or joins a torchrun "
             "group) or repro_torch.devrun.launch(fn, D)")


def check_backend(backend: str, world_size: int, device) -> None:
    """Refuse, by name, a backend the ranks cannot use: ``nccl`` needs a
    card of its own for every rank (NCCL refuses two ranks on one device)
    and does not run on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices, not "
                         f"{dev.type!r}: use gloo on the CPU")
    cards = torch.cuda.device_count()
    if world_size > cards:
        raise ValueError(
            f"nccl needs one card per rank: {world_size} ranks on {cards} "
            f"card(s) — NCCL refuses two ranks on one device; use the gloo "
            f"backend for ranks that share a card (the wire then goes "
            f"through host memory)")


def check_trainable(cfg: ModelConfig, tcfg) -> None:
    """Refuse a bfloat16 or float16 parameter tree by name (a 2-byte
    ``grad_hat_dtype`` on a float32 model trains, as in the reference)."""
    if set(lag_trainer.param_layout(cfg).dtypes) & set(HALF_DTYPES):
        raise NotImplementedError(
            "the devices topology on a bfloat16 or float16 parameter tree "
            "is not ported: the reference's device step does not train "
            "one — its float32 wire payload promotes the parameters to "
            "float32 in round 0 (src/repro/devrun/runner.py:75-79, 188) "
            "and its round 1 fails to trace — so it defines no 2-byte "
            "device round to hold the port to")


def _world(D: int) -> Tuple[int, int]:
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"devices:{D} runs one worker per rank of an "
                           f"initialised torch.distributed group: "
                           f"{_LAUNCHER}")
    world = dist.get_world_size()
    if world != D:
        raise ValueError(
            f"devices:{D} needs a world of {D} ranks, one a worker, got "
            f"{world}: the port has no in-process fallback (the reference "
            f"runs its vmapped trainer on a process with fewer devices "
            f"than workers); use shards:{D} for one process")
    return D, dist.get_rank()


def _resolve(cfg, tcfg, policy, server, topology):
    policy = policy if policy is not None else tcfg.comm_policy()
    server = server if server is not None else tcfg.server_optimizer()
    topology = topology if topology is not None \
        else topo_lib.DeviceWorkers(num_units=tcfg.num_workers)
    if not isinstance(topology, topo_lib.DeviceWorkers):
        raise ValueError(f"devrun builders need a DeviceWorkers topology "
                         f"('devices:D'), got {topology!r}")
    check_trainable(cfg, tcfg)
    D, rank = _world(topology.num_devices(tcfg.num_workers))
    return policy, server, topology, D, rank


def rank_device(device="cuda") -> torch.device:
    """This rank's device: card ``rank mod N`` of the N visible ones (its
    own under nccl; shared under gloo when there are fewer cards than
    ranks), or the CPU when asked for."""
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    idx = dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_device_state(cfg: ModelConfig, tcfg, *, device="cuda",
                      seed: int = 0, params=None, policy=None, server=None,
                      topology=None) -> Dict:
    """This rank's trainer state: ``lag_trainer.init_state`` at local
    W = 1 for the worker's own mirror state (``policy.state_keys``, each
    (1, rows, 128)), with the shared state replicated: θ (from ``params``
    or the seeded draw every rank makes alike), ∇, the history, the
    server's state and the (D,) ``comm_per_worker`` and ``L_m``."""
    import torch.distributed as dist
    policy, server, topology, D, rank = _resolve(cfg, tcfg, policy, server,
                                                 topology)
    check_backend(dist.get_backend(), D, device)
    dev = rank_device(device)
    state = lag_trainer.init_state(cfg, tcfg.replace(num_workers=1),
                                   device=dev, seed=seed, params=params,
                                   policy=policy, server=server)
    lag_state = state["lag"]
    lag_state["comm_per_worker"] = torch.zeros((D,), dtype=torch.int32,
                                               device=dev)
    if policy.needs_L_m:
        lag_state["L_m"] = torch.full((D,), 1.0 / tcfg.lr,
                                      dtype=torch.float32, device=dev)
    return state


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _wire_sum(policy, layout, gathered: Dict[str, torch.Tensor], D: int,
              out: torch.Tensor) -> torch.Tensor:
    """Σ_m of the unpacked gathered wire slots, in worker order, into
    ``out`` (rows, 128) float32, SUM_ROWS rows at a time: what a chunk
    needs moves to ``out``'s device first (a host-staged wire)."""
    chunks = [slice(r, min(r + SUM_ROWS, layout.rows))
              for r in range(0, layout.rows, SUM_ROWS)]
    for m in range(D):
        slot = {k: v[m] for k, v in gathered.items()}   # (1, …) each
        for rs in chunks:
            piece = policy.wire_unpack(layout, slot, rows=rs,
                                       device=out.device)[0]
            if m == 0:
                out[rs].copy_(piece)
            else:
                out[rs].add_(piece)
    return out


def make_device_step(cfg: ModelConfig, tcfg, policy=None, server=None,
                     topology=None, schedule_seed: int = 0):
    """Build this rank's ``train_step(state, batch) → (state, metrics)``.

    ``batch`` is the GLOBAL batch (every rank makes the same one); the rank
    takes its shard.  ``metrics`` adds ``records`` (one per collective
    call of the round, what ``verify.check_wire_accounting`` reads),
    ``gather_ms`` (host clock from the mask gather to the
    summed wire, staging included) and, on the GPU, ``phase_events`` (as
    ``lag_trainer.make_train_step``'s: the gradients, then the round with
    its collectives).
    """
    policy, server, topology, D, rank = _resolve(cfg, tcfg, policy, server,
                                                 topology)
    lo = lag_trainer.param_layout(cfg)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        theta, lag_state, k = state["theta"], state["lag"], state["step"]
        lagcfg = tcfg.lag_config(num_units=D)
        shards = topology.place_batch(batch, D)
        mine = {key: v[rank:rank + 1] for key, v in shards.items()}
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)] \
            if theta.is_cuda else None
        if events:
            events[0].record()
        losses, grads = lag_trainer.worker_grads(theta, lo, cfg, mine)
        gah = None
        if policy.needs_grad_at_hat:
            gah = lag_trainer.grads_at_hat(policy, theta,
                                           lag_state["theta_hat"], lo, cfg,
                                           mine)
        draw = policy.draw(k, D, schedule_seed) if policy.needs_rng else None
        if events:
            events[1].record()
        local = {key: lag_state[key] for key in policy.state_keys}
        local["hist"] = lag_state["hist"]
        if policy.needs_L_m:
            local["L_m"] = lag_state["L_m"][rank:rank + 1]
        comm, delta, new_pst, wire = engine_rounds.policy_rounds(
            policy, lagcfg, theta, grads, local, lo, grad_at_hat=gah,
            step=k, draw=draw, worker_offset=rank, wire_layout=lo)
        del grads, gah

        if theta.is_cuda:
            torch.cuda.synchronize(theta.device)
        t0 = time.perf_counter()
        rec: List[dict] = []
        gmask = collectives.all_gather(comm.reshape(1), records=rec,
                                       what="mask").reshape(D)
        gloss = collectives.all_gather(losses.reshape(1), records=rec,
                                       what="loss").reshape(D)
        gmask, gloss = gmask.to(theta.device), gloss.to(theta.device)
        # the sum goes over this rank's payload buffer (its wire has been
        # gathered or staged: nothing reads it any more)
        out = delta[0] if delta.dtype == torch.float32 else torch.empty(
            delta.shape[1:], dtype=torch.float32, device=theta.device)
        if bool(torch.any(gmask)):
            gathered = {key: collectives.all_gather(v, records=rec, what=key)
                        for key, v in wire.items()}
            del wire
            sum_delta = _wire_sum(policy, lo, gathered, D, out)
            del gathered
        else:
            # an all-quiet round moves the mask and the losses alone
            del wire
            sum_delta = out.zero_()
        if theta.is_cuda:
            torch.cuda.synchronize(theta.device)
        gather_ms = (time.perf_counter() - t0) * 1e3
        # the objective at the pre-step parameters (views of θ), of the
        # worker-order losses, as the in-process trainer's
        loss = server.composite_loss(torch.mean(gloss), lo.unflatten(theta))
        # finish_round frees the sum after the ∇ update, before the server
        # step allocates θ': no name of this frame may hold it then
        del delta, out
        held = [sum_delta]
        del sum_delta
        theta, new_opt, new_lag, metrics = engine_rounds.finish_round(
            policy, server, lagcfg, theta=theta, layout=lo,
            opt_state=state.get("opt"), lag_state=lag_state, comm=gmask,
            sum_delta=held.pop(), new_pst=new_pst, step=k)
        if events:
            events[2].record()
            metrics["phase_events"] = events
        new_state = dict(state, theta=theta, lag=new_lag, step=k + 1)
        if new_opt is not None:
            new_state["opt"] = new_opt
        metrics.update(loss=loss, gather_ms=gather_ms, records=rec)
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# Round loop
# ---------------------------------------------------------------------------

def run_rounds(step_fn, state: Dict, batches) -> Tuple[Dict, list]:
    """Drive ``step_fn`` over ``batches``; the metrics' tensors are moved
    to the host once, at the end (each round already syncs once, on its
    mask)."""
    metrics = []
    for batch in batches:
        state, m = step_fn(state, batch)
        metrics.append(m)
    return state, [{k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in m.items()} for m in metrics]


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _mirror_paths(policy) -> List[str]:
    return [f"['lag'][{k!r}]" for k in policy.state_keys]


def save_checkpoint(ckpt_dir: str, step: int, state: Dict, policy) -> None:
    """Every rank calls this: the workers' mirror state is gathered (on
    the host) and rank 0 writes the ``step_<step>.npz`` that a
    ``shards:D`` run writes at that step."""
    import torch.distributed as dist
    gathered = {}
    for key in policy.state_keys:
        v = state["lag"][key]
        g = collectives.all_gather(v.to("cpu") if dist.get_backend()
                                   == "gloo" else v)
        gathered[key] = g.reshape((g.shape[0],) + tuple(v.shape[1:]))
    if dist.get_rank() == 0:
        store.save(ckpt_dir, step, dict(state, lag=dict(state["lag"],
                                                        **gathered)))
    del gathered
    dist.barrier()


def restore_checkpoint(ckpt_dir: str, state: Dict, policy,
                       step: Optional[int] = None) -> Tuple[Dict, int]:
    """Restore a ``shards:D`` (or ``devices:D``) checkpoint into this
    rank's ``state``, in place: the shared entries whole, row ``rank`` of
    each worker's mirror state."""
    import torch.distributed as dist
    rank = dist.get_rank()
    return store.restore(ckpt_dir, state, step,
                         take={p: rank for p in _mirror_paths(policy)})


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, backend, store_path, threads, fn, args, queue):
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world)
        try:
            queue.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:               # the parent re-raises it by rank
        queue.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world_size: int, *, backend: str = "gloo",
           args: Sequence = (), device="cpu", threads: Optional[int] = None,
           timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, each a
    rank of one group (``backend``) over a ``FileStore`` in a temporary
    directory; returns each rank's result, in rank order.  ``fn`` must be
    importable by name (a module's top-level function).  ``device`` is
    checked against the backend first (``check_backend``); ``threads``
    sets each rank's torch threads.  A rank that raises, or a world that
    has not finished within ``timeout`` seconds, raises here after every
    process has been stopped: no rank survives a failure."""
    import multiprocessing as mp
    import queue as queue_lib
    check_backend(backend, world_size, device)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="devrun_")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend,
                               os.path.join(tmp, "store"), threads, fn,
                               tuple(args), q))
             for r in range(world_size)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"devrun.launch: {world_size - len(results)} of "
                    f"{world_size} ranks had not finished after {timeout} "
                    f"s (ranks {sorted(set(range(world_size)) - set(results))})")
            try:
                rank, ok, val = q.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if dead:
                    # a rank killed before it could report
                    raise RuntimeError(
                        f"devrun.launch: rank(s) {dead} exited with "
                        f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                results[rank] = val
            else:
                errors[rank] = val
                break           # the others may wait on it for ever
        if errors:
            rank = min(errors)
            raise RuntimeError(f"devrun.launch: rank {rank} of {world_size} "
                               f"failed:\n{errors[rank]}")
        for p in procs:
            p.join(max(1.0, min(60.0, deadline - time.monotonic())))
        return [results[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
