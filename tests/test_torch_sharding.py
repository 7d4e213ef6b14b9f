"""The placement rules (``repro_torch.dist.sharding``) against the LIVE
reference's (``repro.dist.sharding``), and what stands on them without a
group of ranks.

- The reference's 14 cases of ``tests/test_sharding.py``, each run with
  its own assertions on the port's ``spec_for`` / ``batch_specs`` /
  ``tree_specs``, every call also held equal to the reference's.
- ``tree_specs`` of the full-size trainer state as ``jax.eval_shape(
  init_state)`` lays it out (lag-ps with an Adam server: every state
  group; LAQ's residual), and the parameters and decode cache, for every
  arch of the registry, on {data:16, model:16}, {pod:2, data:16,
  model:16}, {data:4, model:2} and {data:2, model:1}, in both modes; and
  ``batch_specs`` of every input shape, with and without the sequence on
  "model".
- ``tree_paths`` is ``jax.tree_util.keystr`` over the reference's
  ``model.init`` tree of every arch, and the port's parameter tree has the
  reference's paths and shapes.
- ``RowShard`` and ``RowShardPlan`` on the CPU, the gather done by hand:
  the plane's sums, LAQ's steps and payloads over 1–4 row shards of an
  unaligned buffer bitwise the one-rank plane's.
- The dry-run's ``--mesh single|multi`` for three archs: per-device
  argument bytes equal to the reference formula over its own state, inputs
  and rules; ``--reduced`` refused.
- ``act_shard_axes`` with and without a mesh in context.
"""
import json
import math

import jax
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import applicable as japplicable
from repro.configs.shapes import input_specs as jinput_specs
from repro.dist import TrainerConfig as JTrainerConfig
from repro.dist import init_state as jinit_state
from repro.dist import sharding as jsharding
from repro.models import model as jmodel

import sharded_ranks as ranks
import test_sharding as ref_cases
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_paths
from repro_torch.dist import sharding
from repro_torch.fastpath.layout import BLOCK_ROWS, RowShard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape, mesh_context
from repro_torch.models import model


class FakeMesh:
    """Duck-typed mesh: axis_names + shape mapping (no devices needed)."""
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x2": {"data": 4, "model": 2},
          "2x1": {"data": 2, "model": 1}}
MODES = ("tp", "dp")
CASES = sorted(n for n in dir(ref_cases) if n.startswith("test_"))
DRYRUN_ARCHS = ("llama3.2-1b", "qwen2-vl-7b", "qwen3-moe-235b-a22b")


def both(name):
    """The port's ``name`` of ``sharding``, each call also held to the
    reference's on the same arguments."""
    port, ref = getattr(sharding, name), getattr(jsharding, name)

    def call(*a, **kw):
        got, want = port(*a, **kw), ref(*a, **kw)
        if isinstance(want, dict):
            assert {k: tuple(v) for k, v in got.items()} \
                == {k: tuple(v) for k, v in want.items()}
        else:
            assert tuple(got) == tuple(want), (a, got, want)
        return got
    return call


def test_the_reference_cases_count():
    assert len(CASES) == 14


@pytest.mark.parametrize("case", CASES)
def test_reference_sharding_case(case, monkeypatch):
    for name in ("spec_for", "batch_specs", "tree_specs"):
        if hasattr(ref_cases, name):
            monkeypatch.setattr(ref_cases, name, both(name))
    getattr(ref_cases, case)()


def _eq_trees(port_specs, ref_specs):
    got = [tuple(s) for s in tree_leaves(
        port_specs, is_leaf=lambda x: isinstance(x, sharding.PartitionSpec))]
    want = [tuple(s) for s in jax.tree_util.tree_leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    return got == want


def ref_trainer_state(arch):
    """The reference's full-size state of every group, as shapes: lag-ps
    with an Adam server (ĝ, θ̂, ∇, L_m, Adam's μ/ν), and LAQ's residual."""
    jcfg = jget_config(arch, dtype="bfloat16", param_dtype="bfloat16")
    W = dryrun.arch_worker_count(dryrun.count_params(
        get_config(arch, dtype="bfloat16", param_dtype="bfloat16")))
    out = []
    for kw in (dict(algo="lag-ps", server="adam"), dict(algo="laq")):
        jt = JTrainerConfig(num_workers=W, lr=1e-3,
                            grad_hat_dtype="bfloat16", **kw)
        out.append(jax.eval_shape(lambda: jinit_state(
            jax.random.PRNGKey(0), jcfg, jt)))
    return jcfg, out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_tree_and_batch_specs_equal_the_reference(arch):
    jcfg, states = ref_trainer_state(arch)
    B, S = 32, 256
    cache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, B, S))
    trees = states + [cache]
    for mesh_name, shape in MESHES.items():
        mesh = FakeMesh(shape)
        for mode in MODES:
            for tree in trees:
                assert _eq_trees(sharding.tree_specs(tree, mesh, mode),
                                 jsharding.tree_specs(tree, mesh, mode)), \
                    (arch, mesh_name, mode)
            for shp in JSHAPES:
                if not japplicable(jcfg, shp)[0]:
                    continue
                specs = jinput_specs(jcfg, shp)
                for seq in (True, False):
                    got = sharding.batch_specs(specs, mesh, seq_shard=seq,
                                               mode=mode)
                    want = jsharding.batch_specs(specs, mesh, seq_shard=seq,
                                                 mode=mode)
                    assert {k: tuple(v) for k, v in got.items()} \
                        == {k: tuple(v) for k, v in want.items()}, \
                        (arch, shp, mesh_name, mode, seq)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_tree_paths_are_keystr_and_the_reference_params_tree(arch):
    jcfg = jget_config(arch)
    params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg))
    want = [(jax.tree_util.keystr(p), tuple(leaf.shape)) for p, leaf in
            jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [(p, tuple(l.shape)) for p, l in
            zip(tree_paths(params), tree_flatten(params)[0])] == want
    port = model.templates(get_config(arch))
    assert [(p, tuple(l.shape)) for p, l in
            zip(tree_paths(port), tree_leaves(port))] == want


def test_tree_paths_spell_every_node_kind():
    from collections import namedtuple
    NT = namedtuple("NT", "mu nu")
    tree = {"b": [1, (2, 3)], "a": {"x": NT(4, 5), "0": 6}, "c": None}
    assert tree_paths(tree) == [jax.tree_util.keystr(p) for p, _ in
                                jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_partition_spec_equality_is_the_references():
    P, J = sharding.P, jax.sharding.PartitionSpec
    for entries in ((None, "model"), ("data",), (("pod", "data"), None),
                    (("data",),), ()):
        assert tuple(P(*entries)) == tuple(J(*entries))
    assert P(("data",)) == P("data") and P("data", None) != P("data")


def test_placements_name_a_shard_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sharding.placements(sharding.P("model", ("pod", "data")), mesh) \
        == [Shard(1), Shard(1), Shard(0)]
    assert sharding.placements(sharding.P(None, None), mesh) \
        == [Replicate()] * 3


# ---------------------------------------------------------------------------
# Row shards on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 2, 3, 4])
def test_row_shard_plan_is_bitwise_the_one_rank_plane(N):
    ranks.row_shard_plan_case(N, torch.device("cpu"))


def test_row_shard_cuts_whole_blocks():
    sh = [RowShard(41 * BLOCK_ROWS, 3, r) for r in range(3)]
    assert [s.shard_rows for s in sh] == [14 * BLOCK_ROWS] * 3
    assert [s.valid for s in sh] == [14 * BLOCK_ROWS, 14 * BLOCK_ROWS,
                                     13 * BLOCK_ROWS]
    assert sh[2].stop == sh[2].padded_rows == 42 * BLOCK_ROWS
    with pytest.raises(ValueError, match="multiple of 256"):
        RowShard(100, 2, 0)


# ---------------------------------------------------------------------------
# The dry-run on the production meshes
# ---------------------------------------------------------------------------

def reference_argument_bytes(arch, shape_name, multi_pod):
    """The reference formula: Σ leaf bytes ÷ the product of the mesh axes
    in its spec, over the reference's own dry-run state (its
    ``dryrun_config`` lag-wk trainer with bfloat16 ĝ) and inputs, placed by
    its own rules."""
    jcfg = jget_config(arch, dtype="bfloat16", param_dtype="bfloat16")
    if jcfg.num_experts:
        jcfg = jcfg.replace(moe_seq_shards=16)
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
    W = dryrun.arch_worker_count(dryrun.count_params(
        dryrun.dryrun_config(arch)))
    kind = JSHAPES[shape_name].kind
    specs = jinput_specs(jcfg, shape_name)
    if kind == "train":
        jt = JTrainerConfig(algo="lag-wk", num_workers=W, lr=1e-3,
                            grad_hat_dtype="bfloat16")
        groups = [(jax.eval_shape(lambda: jinit_state(
            jax.random.PRNGKey(0), jcfg, jt)), "tree"), (specs, "batch")]
    else:
        params = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                    jcfg))
        groups = [(params, "tree")]
        if kind == "prefill":
            groups.append((specs, "batch"))
        else:
            shp = JSHAPES[shape_name]
            groups += [(jax.eval_shape(lambda: jmodel.init_cache(
                jcfg, shp.global_batch, shp.seq_len)), "tree"),
                ({"tokens": specs["tokens"]}, "batch"), (specs["pos"], None)]
    total = 0
    for tree, how in groups:
        if how is None:
            total += tree.dtype.itemsize
            continue
        sp = jsharding.tree_specs(tree, mesh) if how == "tree" \
            else jsharding.batch_specs(tree, mesh)
        for leaf, s in zip(jax.tree_util.tree_leaves(tree),
                           jax.tree_util.tree_leaves(
                               sp, is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))):
            n = math.prod(math.prod(mesh.shape[a] for a in (
                e if isinstance(e, tuple) else (e,))) for e in s
                if e is not None)
            total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_dryrun_mesh_argument_bytes_are_the_reference_formula(arch,
                                                              tmp_path):
    rc = dryrun.main(["--arch", arch, "--shape", "all", "--mesh", "both",
                      "--out", str(tmp_path)])
    assert rc == 0
    for shape_name in JSHAPES:
        for mesh_name, multi in (("single_pod_16x16", False),
                                 ("multi_pod_2x16x16", True)):
            rec = json.loads((tmp_path / f"{arch}_{shape_name}_"
                              f"{mesh_name}.json").read_text())
            assert rec["mesh"] == mesh_name
            assert rec["n_devices"] == (512 if multi else 256)
            if rec["status"] == "skipped":
                assert not japplicable(jget_config(arch), shape_name)[0]
                continue
            got = rec["memory"]["argument_size_in_bytes"]
            assert got == reference_argument_bytes(arch, shape_name, multi)
            assert rec["fits"] == (got <= 80e9)
            assert set(rec["memory"]) == {"argument_size_in_bytes"}
            assert "cost" not in rec and "collectives" not in rec


def test_dryrun_mesh_refuses_reduced(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "llama3.2-1b", "--mesh", "single",
                     "--reduced"])
    assert "--reduced" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# act_shard_axes
# ---------------------------------------------------------------------------

def test_act_shard_axes_with_and_without_a_mesh_in_context():
    cfg = get_config("llama3.2-1b").reduced()
    params = model.init(cfg, device="cpu", seed=0)
    tin = {"tokens": torch.zeros((2, 8), dtype=torch.int32)}
    plain = model.forward(params, cfg, tin)
    pinned = cfg.replace(act_shard_axes=("data",))
    with pytest.raises(RuntimeError, match="mesh_context"):
        model.forward(params, pinned, tin)
    host = MeshShape((2, 1), ("data", "model"))
    with mesh_context(host):
        assert torch.equal(model.forward(params, pinned, tin), plain)
        assert torch.equal(model.forward(params, pinned.replace(
            act_shard_seq=True), tin), plain)
        with pytest.raises(ValueError, match=r"\['pod'\]"):
            model.forward(params, cfg.replace(act_shard_axes=("pod",
                                                              "data")), tin)
    with mesh_context(MeshShape((2, 1), ("data", "other"))):
        with pytest.raises(ValueError, match=r"\['model'\]"):
            model.forward(params, pinned.replace(act_shard_seq=True), tin)
    with pytest.raises(RuntimeError, match="mesh_context"):
        model.forward(params, pinned, tin)
