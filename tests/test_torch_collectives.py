"""The port's collective accounting (``repro_torch.dist.collectives``)
against the reference's HLO analysis (``repro.dist.hlo_analysis``).

The reference charges the collectives it parses from compiled HLO; the
port writes one record per call it makes.  Given the same ops —
``tests/test_hlo_analysis.py``'s cases, each written as records — the two
totals agree exactly, by kind, count and cross-pod bytes.  The record
writer itself runs here in a gloo group of one rank: every dtype crosses
as its bytes (16-bit codes included, which gloo has no type for), in rank
order, one record a call.
"""
import os

import pytest
import torch

from repro.dist.hlo_analysis import _wire_bytes as jwire_bytes
from repro.dist.hlo_analysis import collective_bytes as jcollective_bytes

from repro_torch.dist import collectives
from repro_torch.dist.collectives import _wire_bytes, collective_bytes

# (the reference's HLO text, the same ops as records, kwargs of both)
CASES = {
    "all_reduce_ring": (
        "  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, "
        "to_apply=%add",
        [{"kind": "all-reduce", "bytes": 4096, "group": [0, 1, 2, 3]}], {}),
    "gather_and_permute": (
        "  %ag = bf16[64,256]{1,0} all-gather(%y), replica_groups={{0,1},"
        "{2,3}}, dimensions={0}\n"
        "  %cp = f32[128]{0} collective-permute(%z), source_target_pairs="
        "{{0,1},{1,0}}",
        [{"kind": "all-gather", "bytes": 64 * 256 * 2, "group": [0, 1]},
         {"kind": "collective-permute", "bytes": 512}], {}),
    "start_done_once": (
        "  %ars = f32[100]{0} all-reduce-start(%x), replica_groups={{0,1}}\n"
        "  %ard = f32[100]{0} all-reduce-done(%ars)",
        [{"kind": "all-reduce", "bytes": 400, "group": [0, 1]}], {}),
    "cross_pod": (
        "  %a = f32[100]{0} all-reduce(%x), replica_groups={{0,1}}, "
        "to_apply=%add\n"
        "  %b = f32[100]{0} all-reduce(%y), replica_groups={{0,4}}, "
        "to_apply=%add",
        [{"kind": "all-reduce", "bytes": 400, "group": [0, 1]},
         {"kind": "all-reduce", "bytes": 400, "group": [0, 4]}],
        {"pod_size": 4}),
    "iota_groups": (
        "  %a = f32[256]{0} all-reduce(%x), replica_groups=[2,2]<=[4], "
        "to_apply=%add",
        [{"kind": "all-reduce", "bytes": 1024, "group": [0, 1]}],
        {"pod_size": 2}),
    "empty_groups_all_devices": (
        "  %a = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups="
        "{}, to_apply=%add",
        [{"kind": "all-reduce", "bytes": 4096, "group": []}],
        {"pod_size": 2, "n_devices": 4}),
    "empty_groups_unknown": (
        "  %a = f32[1024]{0} all-reduce(%x), channel_id=1, replica_groups="
        "{}, to_apply=%add",
        [{"kind": "all-reduce", "bytes": 4096}], {}),
    "async_gather_result": (
        "  %ags = (bf16[64,128]{1,0}, bf16[64,256]{1,0}) all-gather-start(%x),"
        " replica_groups={{0,1}}, dimensions={1}\n"
        "  %agd = bf16[64,256]{1,0} all-gather-done(%ags)",
        [{"kind": "all-gather", "bytes": 64 * 256 * 2, "group": [0, 1]}], {}),
    "non_collectives": (
        "  %d = f32[8,8]{1,0} dot(%a, %b)\n  %c = f32[8]{0} add(%e, %f)",
        [], {}),
    "reduce_scatter_and_all_to_all": (
        "  %rs = f32[256]{0} reduce-scatter(%x), replica_groups={{0,1,2}}, "
        "dimensions={0}, to_apply=%add\n"
        "  %aa = f32[300]{0} all-to-all(%y), replica_groups={{0,1,2}}, "
        "dimensions={0}",
        [{"kind": "reduce-scatter", "bytes": 1024, "group": [0, 1, 2]},
         {"kind": "all-to-all", "bytes": 1200, "group": [0, 1, 2]}], {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_records_total_as_the_reference_counts_hlo(case):
    hlo, records, kw = CASES[case]
    want = jcollective_bytes(hlo, **kw)
    got = collective_bytes(records, **kw)
    assert got.total_bytes == want.total_bytes
    assert got.cross_pod_bytes == want.cross_pod_bytes
    assert got.by_kind == want.by_kind
    assert got.by_kind_count == want.by_kind_count
    assert len(got.ops) == len(want.ops)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute", "send"])
def test_ring_costs_are_the_references(kind):
    for n in (0, 1, 2, 3, 4, 8, 512):
        for nbytes in (0.0, 1.0, 4096.0, 2.0 ** 33 + 12.0):
            assert _wire_bytes(kind, nbytes, n) \
                == jwire_bytes(kind, nbytes, n)


@pytest.fixture
def group_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_all_gather_writes_one_record_a_call(group_of_one):
    recs = []
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = collectives.all_gather(x, records=recs, what="payload")
    assert got.shape == (1, 2, 3) and torch.equal(got[0], x)
    codes = torch.tensor([1, 65534, 300], dtype=torch.uint16)
    assert torch.equal(collectives.all_gather(codes, records=recs)[0],
                       codes)
    mask = torch.tensor([True])
    assert torch.equal(collectives.all_gather(mask, records=recs)[0], mask)
    assert [r["bytes"] for r in recs] == [24, 6, 1]
    assert recs[0] == {"kind": "all-gather", "bytes": 24, "group": [0],
                       "what": "payload", "staged_bytes": 0}
    # a group of one moves nothing on the wire
    assert collective_bytes(recs, 1).total_bytes == 0.0
    # the same records in a group of four: B(n−1)/n each
    four = [dict(r, group=[0, 1, 2, 3], bytes=4 * r["bytes"]) for r in recs]
    assert collective_bytes(four).total_bytes == 3 * (24 + 6 + 1)


def test_summary_pairs_counted_and_declared_bytes():
    from repro_torch.comm import make_policy
    stats = collective_bytes([{"kind": "all-gather", "bytes": 800,
                               "group": [0, 1]}])
    tree = {"w": torch.zeros(10, 10)}
    out = collectives.policy_traffic_summary(stats, make_policy("laq@4"),
                                             tree, uploads=3)
    assert out["collectives"]["total_bytes"] == 400.0
    assert out["logical_upload_bytes"] == 3 * (100 * 4 / 8 + 4)
    assert out["policy"] == "laq"
