"""One-card dry-run: reckon every (architecture × input shape) on the meta
device — port of ``repro.launch.dryrun`` for one card.

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \
        --out /tmp/dryrun
    python -m repro_torch.launch.dryrun --arch all --shape all --out DIR
    python -m repro_torch.launch.dryrun --arch all --shape all --reduced \
        --batch 4 --seq 64 --workers 2 --out DIR     # the tests' sizes
    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \
        --dtype float16 --out DIR                    # a float16 config

The reference lowers and compiles each step on its production mesh with
shape stand-ins and reads XLA's memory and cost analyses.  The port runs
the same entry points a user calls (``init_state`` + ``make_train_step``
with the batched plane, ``model.prefill``, ``model.decode_step``) on
``meta`` tensors: nothing is allocated or computed, and the comm plane's
kernel wrappers allocate their outputs as on the card.  A dispatch mode
follows every tensor the step makes and the storages alive at each op, so
the reckoned peak is the step's own allocation pattern; FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``, the activations saved for
the backward from ``torch.autograd.graph.saved_tensors_hooks``.

Per combination it reckons: the state's bytes tree by tree (θ and the
``lag`` group's buffers from the port's own layout and ``init_state``; the
parameters and the decode cache when serving), the inputs' bytes, the
saved activations, the FLOPs of one step, ``peak_bytes`` (state + inputs +
the step's largest live transient), ``fits`` against the card's memory and
``max_layers``, the largest depth whose peak fits at the same width, W,
batch and sequence.  One JSON file per combination under ``--out``, with
the reference's record keys where their meaning carries over
(``memory.argument_size_in_bytes``: state + inputs;
``memory.temp_size_in_bytes``: the transient peak; ``cost.flops``;
``status``; ``workers``) and ``mesh: "one_card"`` (``--mesh one_card``,
the default).

``--mesh single|multi|both`` reckons the reference's production meshes
instead, under its record names (``single_pod_16x16``, 256 devices;
``multi_pod_2x16x16``, 512): per device, ``memory.argument_size_in_bytes``
is the sum over the reference-layout state and inputs (the reference's
``init_state`` tree of its ``dryrun_config`` trainer — lag-wk, bfloat16 ĝ
— and ``arch_worker_count`` workers; the parameters, the decode cache and
the inputs when serving) of each leaf's bytes over the product of the
mesh axes its ``dist.sharding`` spec names, and ``fits`` reads it against
one H100's 80 GB.  Temporaries, FLOPs and collectives on a mesh are not
reckoned: the reference reads them from the program XLA compiled for the
mesh, and the port has no compiled program (the port runs no tensor
parallelism; its collectives are counted at the call,
``dist.collectives``), so those keys are absent, not guessed.  They are
refused with ``--reduced``.  A
bfloat16 or float16 config that keeps float32 leaves (the MoE router,
mamba2's and RG-LRU's float32 leaves) reckons its training state as the trainer holds
it: two parts a tree (``fastpath.layout.Parts``), each at its leaves'
dtype, and each plane op launched once per part.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.utils.weak
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ALL_ARCHS, ASSIGNED, get_config
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.dist import sharding
from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                          make_train_step)
from repro_torch.fastpath.layout import Parts
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
from repro_torch.models.common import ModelConfig

#: the card's memory (H100 SXM: 80 GB)
CARD_BYTES = 80e9
MESH = "one_card"
#: ``--mesh`` → the reference's production meshes, by its record names
MESHES = {"single": (("single_pod_16x16", False),),
          "multi": (("multi_pod_2x16x16", True),),
          "both": (("single_pod_16x16", False), ("multi_pod_2x16x16", True))}


def arch_worker_count(n_params: int) -> int:
    """The reference's LAG worker count for an arch's size (its DESIGN.md
    §6): per-device extra = W·|θ|·bytes/N_devices."""
    if n_params > 6e10:
        return 2
    if n_params > 5e9:
        return 4
    return 16


def count_params(cfg: ModelConfig) -> int:
    """Parameters of ``cfg``'s tree (shapes only)."""
    return sum(math.prod(t.shape) for t in tree_leaves(model.templates(cfg)))


def dryrun_config(arch: str, dtype: str = "bfloat16") -> ModelConfig:
    """The reference's dry-run config: bfloat16 params and compute (or
    ``dtype``'s, float16); MoE groups aligned with its 16-way model
    axis."""
    cfg = get_config(arch, dtype=dtype, param_dtype=dtype)
    if cfg.num_experts:
        cfg = cfg.replace(moe_seq_shards=16)
    return cfg


# ---------------------------------------------------------------------------
# The reckoning
# ---------------------------------------------------------------------------

def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages alive among the tensors made under the mode,
    and their peak.  A storage counts from the op that makes it until the
    last tensor on it made under the mode is freed; storages of
    ``external`` tensors (the state, the inputs) are not counted, so an
    in-place op on them adds nothing."""

    def __init__(self, external=()):
        super().__init__()
        self.external = {_key(t) for t in external
                         if isinstance(t, torch.Tensor)}
        self.seen = torch.utils.weak.WeakIdKeyDictionary()
        self.refs: Dict[int, list] = {}
        self.live = self.peak = 0

    def _drop(self, key: int) -> None:
        ref = self.refs[key]
        ref[1] -= 1
        if ref[1] == 0:
            del self.refs[key]
            self.live -= ref[0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out) if isinstance(out, (tuple, list)) \
                else [out]:
            if not isinstance(t, torch.Tensor) or t in self.seen:
                continue
            self.seen[t] = True
            key = _key(t)
            if key in self.external:
                continue
            if key in self.refs:
                self.refs[key][1] += 1
            else:
                n = t.untyped_storage().nbytes()
                self.refs[key] = [n, 1]
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._drop, key)
        return out


class SavedBytes:
    """Bytes of the distinct storages autograd saves for the backward
    (``external`` ones, the parameters', not counted)."""

    def __init__(self, external=()):
        self.external = {_key(t) for t in external
                         if isinstance(t, torch.Tensor)}
        self.keys: Dict[int, int] = {}

    def pack(self, t: torch.Tensor):
        key = _key(t)
        if key not in self.external:
            self.keys.setdefault(key, t.untyped_storage().nbytes())
        return t

    @property
    def total(self) -> int:
        return sum(self.keys.values())


def _nbytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() if t.is_contiguous()
               else t.numel() * t.element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _measure(fn, external, *, grad: bool):
    """Run ``fn`` under the live-bytes, FLOP and saved-tensor counters."""
    live, saved = LiveBytes(external), SavedBytes(external)
    flops = FlopCounterMode(display=False)
    with torch.autograd.graph.saved_tensors_hooks(saved.pack, lambda t: t), \
            flops, live, torch.set_grad_enabled(grad):
        out = fn()
        del out
    return live.peak, saved.total, flops.get_total_flops()


def reckon_train(cfg: ModelConfig, tcfg: TrainerConfig, batch: Dict,
                 policy=None) -> Dict:
    """One training step of ``make_train_step(cfg, tcfg)`` on meta
    tensors: the state's bytes per tree, the inputs', the saved
    activations, the FLOPs and the peak.  The step runs on the batched
    plane; on the legacy per-leaf route under ``tcfg.use_pallas_comm``
    (each leaf's plain version on meta tensors, the kernels' outputs), and
    on the plain route for a ``policy`` without a plan
    (``comm.make_policy(fastpath=None)``)."""
    if policy is None and not tcfg.use_pallas_comm:
        tcfg = tcfg.replace(fastpath="on")
    params = model.templates(cfg)
    state = init_state(cfg, tcfg, device="meta", params=params,
                       policy=policy)
    trees = {"theta": _nbytes(state["theta"])}
    trees.update({f"lag.{k}": _nbytes(v) for k, v in state["lag"].items()
                  if isinstance(v, (torch.Tensor, Parts))})
    if "opt" in state:
        trees["opt"] = _nbytes(state["opt"])
    step = make_train_step(cfg, tcfg, policy=policy)
    external = tree_leaves(state) + tree_leaves(batch)
    temp, saved, flops = _measure(lambda: step(state, batch), external,
                                  grad=True)
    return _record(trees, _nbytes(batch), temp, saved, flops)


def reckon_serve(cfg: ModelConfig, kind: str, inputs: Dict, max_len: int
                 ) -> Dict:
    """A prefill (``kind`` "prefill") or one decode step on meta tensors:
    the parameters' (and the decode cache's) bytes, the inputs', FLOPs and
    the peak."""
    params = model.templates(cfg)
    trees = {"params": _nbytes(params)}
    if kind == "prefill":
        run = lambda: model.prefill(params, cfg, inputs, max_len=max_len)
        external = tree_leaves(params) + tree_leaves(inputs)
    else:
        B = inputs["tokens"].shape[0]
        cache = model.init_cache(cfg, B, max_len, device="meta")
        trees["cache"] = _nbytes(cache)
        run = lambda: model.decode_step(params, cfg, cache, inputs["tokens"],
                                        inputs["pos"])
        external = tree_leaves(params) + tree_leaves(cache) \
            + [inputs["tokens"]]
    temp, _, flops = _measure(run, external, grad=False)
    return _record(trees, _nbytes(inputs), temp, 0, flops)


def _record(trees, input_bytes, temp, saved, flops) -> Dict:
    args = sum(trees.values()) + input_bytes
    return {"memory": {"argument_size_in_bytes": args,
                       "temp_size_in_bytes": temp,
                       "state_bytes": trees, "input_bytes": input_bytes,
                       "saved_activation_bytes": saved,
                       "peak_bytes": args + temp},
            "cost": {"flops": float(flops)}}


def reckon(cfg: ModelConfig, shape_name: str, workers: int,
           batch: Optional[int] = None, seq: Optional[int] = None,
           tcfg: Optional[TrainerConfig] = None, policy=None) -> Dict:
    """The reckoning of ``cfg`` at ``shape_name`` (``batch`` / ``seq``
    override the shape's): a training step at ``workers`` with ``tcfg``
    (default: the reference's dry-run trainer, lag-wk with bfloat16 ĝ, or
    float16 ĝ for a float16 config) and ``policy``
    (:func:`reckon_train`), else the serving step."""
    shp = SHAPES[shape_name]
    inputs = input_specs(cfg, shape_name, batch, seq)
    if shp.kind == "train":
        gh = "float16" if cfg.param_dtype == "float16" else "bfloat16"
        tcfg = tcfg or TrainerConfig(algo="lag-wk", num_workers=workers,
                                     lr=1e-3, grad_hat_dtype=gh)
        return reckon_train(cfg, tcfg.replace(num_workers=workers), inputs,
                            policy)
    return reckon_serve(cfg, shp.kind, inputs, seq or shp.seq_len)


# ---------------------------------------------------------------------------
# The production meshes: per-device argument bytes under the rules
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def reference_arguments(cfg: ModelConfig, shape_name: str, workers: int
                        ) -> Dict:
    """The arguments of the reference's dry-run program for ``cfg`` at
    ``shape_name`` as meta tensors, in its layout: ``{"state", "batch"}``
    for training (its ``init_state`` tree of a lag-wk trainer with
    bfloat16 ĝ: ``params``, ``lag`` = ĝ stacked over the ``workers``, ∇,
    the history, the counters, and ``step``), ``{"params", "batch"}`` for
    a prefill, ``{"params", "cache", "tokens", "pos"}`` for a decode
    step."""
    shp = SHAPES[shape_name]
    params = model.templates(cfg)
    inputs = input_specs(cfg, shape_name)
    if shp.kind == "train":
        W = workers
        lag_state = {
            "grad_hat": tree_map(lambda p: _meta((W,) + tuple(p.shape),
                                                 torch.bfloat16), params),
            "nabla": tree_map(lambda p: _meta(p.shape, p.dtype), params),
            "hist": _meta((10,), torch.float32),
            "comm_total": _meta((), torch.int32),
            "comm_per_worker": _meta((W,), torch.int32)}
        return {"state": {"params": params, "lag": lag_state,
                          "step": _meta((), torch.int32)},
                "batch": inputs}
    if shp.kind == "prefill":
        return {"params": params, "batch": inputs}
    B = inputs["tokens"].shape[0]
    return {"params": params,
            "cache": model.init_cache(cfg, B, shp.seq_len, device="meta"),
            "tokens": {"tokens": inputs["tokens"]},
            "pos": _meta((), torch.int32)}


def argument_bytes_per_device(args: Dict, mesh) -> int:
    """Σ over ``args``' leaves of each leaf's bytes over the product of
    the mesh axes in its spec: ``tree_specs`` for the state, parameters and
    cache (each placed as its own tree, as the reference's dry-run places
    them), ``batch_specs`` (sequence over model) for the inputs, the
    decode position replicated."""
    total = 0
    for group, tree in args.items():
        if group == "pos":
            total += 4
            continue
        specs = sharding.batch_specs(tree, mesh) if group in (
            "batch", "tokens") else sharding.tree_specs(tree, mesh)
        leaves = tree_leaves(tree)
        spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(
            x, sharding.PartitionSpec))
        total += sum(sharding.shard_bytes(s, t.numel() * t.element_size(),
                                          mesh)
                     for s, t in zip(spec_leaves, leaves))
    return total


def run_mesh(arch: str, shape_name: str, workers: int, mesh_name: str,
             multi_pod: bool, budget: float = CARD_BYTES) -> Dict:
    """One ``--mesh single|multi`` record: the reference's record keys for
    what carries over without a compiled program."""
    cfg = dryrun_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = math.prod(mesh.dims)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "n_devices": n, "dtype": "bfloat16"}
    ok, reason = applicable(cfg, shape_name)
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    per_dev = argument_bytes_per_device(
        reference_arguments(cfg, shape_name, workers), mesh)
    rec.update(status="ok", memory={"argument_size_in_bytes": per_dev},
               card_bytes=budget, fits=per_dev <= budget,
               not_reckoned=("temp_size_in_bytes, cost and collectives: "
                             "the reference reads them from the program "
                             "XLA compiled for the mesh; the port has none"),
               reckon_s=round(time.time() - t0, 2))
    if SHAPES[shape_name].kind == "train":
        rec["workers"] = workers
    return rec


def max_layers(cfg: ModelConfig, shape_name: str, workers: int,
               budget: float = CARD_BYTES, full: Optional[Dict] = None,
               **kw) -> int:
    """The largest depth (0 when one layer does not fit) whose reckoned
    peak is under ``budget`` at the same width, W, batch and sequence: an
    affine estimate from one and two superblocks, then checked by
    reckoning.  ``full`` is the full depth's reckoning, if made."""
    L = cfg.num_layers
    peak = lambda n: reckon(cfg.replace(num_layers=n), shape_name, workers,
                            **kw)["memory"]["peak_bytes"]
    if (full["memory"]["peak_bytes"] if full else peak(L)) <= budget:
        return L
    p = max(1, len(cfg.block_pattern))
    n1, n2 = min(p, L), min(2 * p, L)
    p1 = peak(n1)
    if p1 > budget:
        n = n1 - 1
        while n > 0 and peak(n) > budget:
            n -= 1
        return n
    slope = (peak(n2) - p1) / (n2 - n1) if n2 > n1 else 0.0
    n = L if slope <= 0 else min(L, n1 + int((budget - p1) // slope))
    while n > n1 and peak(n) > budget:
        n -= 1
    while n < L and peak(n + 1) <= budget:
        n += 1
    return n


def run_one(arch: str, shape_name: str, workers: int,
            budget: float = CARD_BYTES, reduced: bool = False,
            batch: Optional[int] = None, seq: Optional[int] = None,
            dtype: str = "bfloat16") -> Dict:
    cfg = dryrun_config(arch, dtype)
    if reduced:
        cfg = cfg.reduced()
    ok, reason = applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "n_devices": 1,
           "dtype": dtype}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        full = reckon(cfg, shape_name, workers, batch, seq)
    except NotImplementedError as e:      # the trainer's refusal, by name
        rec.update(status="skipped", reason=str(e))
        return rec
    except Exception as e:  # noqa: BLE001 — a failure here is a finding
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    rec.update(status="ok", **full)
    if SHAPES[shape_name].kind == "train":
        rec["workers"] = workers
    peak = full["memory"]["peak_bytes"]
    rec.update(card_bytes=budget, fits=peak <= budget,
               num_layers=cfg.num_layers,
               max_layers=max_layers(cfg, shape_name, workers, budget,
                                     full=full, batch=batch, seq=seq),
               reckon_s=round(time.time() - t0, 2))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--workers", type=int, default=None,
                   help="LAG workers of a training shape (default: the "
                        "reference's arch_worker_count)")
    p.add_argument("--include-sw", action="store_true",
                   help="also run the llama3.2-1b-sw beyond-paper variant")
    p.add_argument("--reduced", action="store_true",
                   help="the reduced configs (the tests' sizes)")
    p.add_argument("--batch", type=int, default=None,
                   help="override the shapes' global batch")
    p.add_argument("--seq", type=int, default=None,
                   help="override the shapes' sequence length")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float16"),
                   help="params and compute (the reference's: bfloat16); "
                        "training keeps ĝ at this dtype")
    p.add_argument("--mesh", default=MESH,
                   choices=(MESH,) + tuple(MESHES),
                   help="one_card (default): the meta-device reckoning on "
                        "one H100; single / multi / both: the reference's "
                        "16x16 / 2x16x16 meshes, per-device argument bytes "
                        "under the placement rules")
    args = p.parse_args(argv)
    if args.mesh != MESH and (args.reduced or args.dtype != "bfloat16"
                              or args.batch or args.seq):
        p.error(f"--mesh {args.mesh} reckons the reference's dry-run "
                f"configs at their own sizes: it takes no --reduced, "
                f"--dtype, --batch or --seq")

    archs = [args.arch] if args.arch != "all" \
        else (ALL_ARCHS if args.include_sw else ASSIGNED)
    shapes = [args.shape] if args.shape != "all" else list(SHAPES)
    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        workers = args.workers or arch_worker_count(
            count_params(dryrun_config(arch)))
        for shape_name in shapes:
            if args.mesh != MESH:
                for mesh_name, multi in MESHES[args.mesh]:
                    rec = run_mesh(arch, shape_name, workers, mesh_name,
                                   multi)
                    _write(args.out, f"{arch}_{shape_name}_{mesh_name}", rec)
                    if rec["status"] == "ok":
                        gib = rec["memory"]["argument_size_in_bytes"] / 2**30
                        extra = f" args/dev={gib:.2f}GiB fits={rec['fits']}"
                    else:
                        extra = " " + rec["reason"][:160]
                    print(f"[{rec['status']:7s}] {arch} × {shape_name} × "
                          f"{mesh_name}{extra}", flush=True)
                continue
            rec = run_one(arch, shape_name, workers, CARD_BYTES,
                          args.reduced, args.batch, args.seq, args.dtype)
            tag = "" if args.dtype == "bfloat16" else f"_{args.dtype}"
            _write(args.out, f"{arch}_{shape_name}_{MESH}{tag}", rec)
            status, extra = rec["status"], ""
            if status == "ok":
                mem = rec["memory"]
                extra = (f" reckon={rec['reckon_s']}s "
                         f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB"
                         f" peak={mem['peak_bytes'] / 2**30:.2f}GiB "
                         f"fits={rec['fits']} max_layers={rec['max_layers']}"
                         f"/{rec['num_layers']} "
                         f"flops={rec['cost']['flops']:.3g}")
            elif status == "error":
                n_fail += 1
                extra = " " + rec["error"][:160]
            else:
                extra = " " + rec["reason"][:160]
            print(f"[{status:7s}] {arch} × {shape_name} × {MESH}{extra}",
                  flush=True)
    print(f"done ({n_fail} failures)")
    return n_fail


def _write(out: str, stem: str, rec: Dict) -> None:
    with open(os.path.join(out, stem.replace("/", "_") + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
