"""Close the prediction loop: COUNTED collective bytes vs the policy's
declared wire cost — port of ``repro.devrun.verify``.

The communication numbers come from two independent places:

  * **declared** — ``CommPolicy.wire_bytes(params)``, the constant every
    metrics row is a rescaling of (one upload of the param-shaped
    gradient);
  * **counted** — ``repro_torch.dist.collectives.collective_bytes`` over the
    records the device plane's collective wrapper writes, one per call
    (the reference measures its compiled HLO instead: a PyTorch program
    has none), with the reference's ring-cost convention.

They do not match exactly — the wire format frames the payload — and the
gap has nameable components:

  ===========================  ============================================
  component                    size
  ===========================  ============================================
  flat-buffer padding          ``layout.rows·LANES ≥ Σ param sizes``:
                               each leaf pads to whole 1024-element
                               sub-blocks, the tail to a whole 256-row
                               block (``repro_torch.fastpath.layout``)
  code-width rounding          LAQ stores b-bit codes at the next packed
                               width ∈ {2, 4, 8, 16}; b = 3 ships at
                               4 bits (4/3×), b ∈ {2, 4, 8, 16} at 1×
  trigger-mask gather          D bool slots per round — what an
                               all-quiet round still moves
  loss gather                  D float32 losses, gathered beside the mask
  ===========================  ============================================

``FRAMING_TOLERANCE`` bounds the *format* gap (slot bytes vs declared
bytes, both constants — checked exactly); ``GATHER_REL_TOL`` bounds the
*measurement* gap (counted ring-cost totals vs the predicted per-rank
traffic).  The port counts every call it makes, so on a round where some
worker fired the count equals the prediction exactly; the tests hold it
so.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.core.tree import tree_map
from repro_torch.dist import collectives
from repro_torch.fastpath.layout import FlatLayout

Pytree = Any

#: relative bound on (packed wire slot bytes) / (policy-declared bytes) − 1
#: (the reference's): flat-buffer padding — ≤ (1023 per leaf + one
#: 32768-element tail block) / param count, ≈ 2.4 % for the reduced llama —
#: times LAQ's code-width rounding (4/3 at b = 3, 1 at the packed widths).
#: The worst supported case, b = 3 with padding, 4/3 · 1.024 ≈ 1.366, is
#: bounded with headroom.
FRAMING_TOLERANCE = 0.40

#: relative bound on counted vs predicted collective bytes (the
#: reference's, which absorbs its compiler's bookkeeping collectives; the
#: port's count is exact)
GATHER_REL_TOL = 0.10


def _payload_layout(params: Pytree) -> FlatLayout:
    """The wire layout: the flat-buffer table of the param-shaped float32
    payload every policy's ``wire_pack`` consumes (shapes only: no
    memory)."""
    return FlatLayout.for_tree(tree_map(
        lambda p: torch.empty(tuple(p.shape), dtype=torch.float32,
                              device="meta"), params))


def predicted_collective_bytes(policy, params: Pytree,
                               n_devices: int) -> Dict[str, Any]:
    """What a device round where some worker fired SHOULD move per rank,
    from the wire format alone, in the ring-cost convention.

    Per wire slot of ``slot`` bytes a rank, the all-gather's output is
    ``n·slot`` bytes, so the per-rank ring cost is ``slot·(n−1)``.  The
    side channels are the mask gather (n bool slots: n−1 bytes) and the
    loss: the port gathers the n float32 losses beside the mask, 4·(n−1)
    bytes (the reference all-reduces one float32 mean: 2·4·(n−1)/n).  An
    all-quiet round moves the two side channels alone.
    """
    layout = _payload_layout(params)
    slots = policy.wire_slot_bytes(layout)
    slot_total = float(sum(slots.values()))
    n = n_devices
    gather = slot_total * (n - 1)
    mask = float(n - 1)                      # n bools, B(n−1)/n
    loss = 4.0 * (n - 1)                     # n float32, B(n−1)/n
    return {
        "slots": dict(slots),
        "slot_total": slot_total,
        "gather_bytes": gather,
        "mask_bytes": mask,
        "loss_bytes": loss,
        "total": gather + mask + loss,
    }


def framing_ratio(policy, params: Pytree) -> float:
    """(packed wire slot bytes per upload) / (policy-declared bytes per
    upload) — both constants, so this is exact."""
    layout = _payload_layout(params)
    slot_total = float(sum(policy.wire_slot_bytes(layout).values()))
    return slot_total / policy.wire_bytes(params)


def check_wire_accounting(records: List[dict], policy, params: Pytree,
                          n_devices: int) -> Dict[str, Any]:
    """Count one round's collectives and line them up with the predictions.

    Returns the accounting record: counted ring-cost totals by collective
    kind, the wire-format prediction, the declared policy bytes, and the
    two relative gaps the tolerances bound.
    """
    stats = collectives.collective_bytes(records, n_devices=n_devices)
    pred = predicted_collective_bytes(policy, params, n_devices)
    declared = float(policy.wire_bytes(params))
    ratio = framing_ratio(policy, params)
    measured = float(stats.total_bytes)
    rel = abs(measured - pred["total"]) / max(pred["total"], 1.0)
    return {
        "n_devices": n_devices,
        "measured_total_bytes": measured,
        "measured_by_kind": dict(stats.by_kind),
        "measured_op_count": len(stats.ops),
        "staged_bytes": stats.staged_bytes,
        "predicted": pred,
        "declared_bytes_per_upload": declared,
        "framing_ratio": ratio,
        "gather_rel_err": rel,
    }


def assert_wire_accounting(records: List[dict], policy, params: Pytree,
                           n_devices: int,
                           gather_rel_tol: float = GATHER_REL_TOL,
                           framing_tol: float = FRAMING_TOLERANCE
                           ) -> Dict[str, Any]:
    """``check_wire_accounting`` + the two bounds, as hard asserts:
    counted collective bytes ≈ the predicted wire traffic
    (``gather_rel_tol``), and packed slot bytes within ``framing_tol``
    ABOVE the declared ``wire_bytes`` (the format only adds framing)."""
    acct = check_wire_accounting(records, policy, params, n_devices)
    if acct["gather_rel_err"] > gather_rel_tol:
        raise AssertionError(
            f"counted collective bytes diverge from the wire-format "
            f"prediction: counted {acct['measured_total_bytes']:.0f} vs "
            f"predicted {acct['predicted']['total']:.0f} "
            f"(rel {acct['gather_rel_err']:.3f} > {gather_rel_tol}); "
            f"by kind: {acct['measured_by_kind']}")
    ratio = acct["framing_ratio"]
    if not (1.0 - 1e-6 <= ratio <= 1.0 + framing_tol):
        raise AssertionError(
            f"wire framing ratio {ratio:.4f} outside [1, 1+{framing_tol}]: "
            f"slot bytes {acct['predicted']['slot_total']:.0f} vs declared "
            f"{acct['declared_bytes_per_upload']:.0f} — either the packed "
            f"format regressed or wire_bytes mis-declares")
    return acct
