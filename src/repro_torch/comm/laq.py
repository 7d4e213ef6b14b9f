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
under ``use_pallas`` (two launches per leaf), else the plain version.

On the device plane (``repro_torch.devrun``) a triggered upload crosses
between ranks as what it is: b-bit codes packed into bytes plus the
per-leaf quantizer steps (:func:`pack_codes`), not the float32 payload.
The steps on the wire are the encode's own (``aux["wire_steps"]``, the
IEEE division of the scale by qmax), so decoding is one float32 multiply
of the recovered integer by the step the encoder used, and
``unpack_codes(pack_codes(payload)) == payload`` (bit for bit but for a
code rounded to −0, which comes back +0, as in the reference).  Packing and
unpacking are plain tensor ops, as in the reference, which computes them
outside any Pallas kernel; they run in chunks of rows, so a full-width
payload takes no second float32 copy.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.comm.base import CommPolicy, CommRound, PolicyState, Pytree
from repro_torch.core import lag
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.fastpath.layout import BLOCK_ROWS, LANES, SUB_ROWS
from repro_torch.kernels.lag_trigger import ops as lag_ops

#: rows packed or unpacked at a time: 2^16 rows, 32 MiB of float32 a
#: worker — whole 256-row blocks, so every packed width divides it
CHUNK_ROWS = 1 << 16


def wire_code_width(bits: int) -> int:
    """Storage bits per code on the wire: ``bits`` rounded up to the next
    packable width (2/4/8 sub-byte in uint8, else uint16)."""
    return 2 if bits <= 2 else 4 if bits <= 4 else 8 if bits <= 8 else 16


def _step_rows(layout, steps: torch.Tensor,
               rows: Optional[slice] = None) -> torch.Tensor:
    """(W, num_leaves) per-leaf steps → (W, rows) per-row steps via the
    layout's static sub-block → leaf table (of the rows ``rows``, whole
    sub-blocks, alone)."""
    rs = slice(0, layout.rows) if rows is None else rows
    seg = torch.as_tensor(
        layout.sub_leaf[rs.start // SUB_ROWS:rs.stop // SUB_ROWS],
        dtype=torch.long, device=steps.device)
    return torch.repeat_interleave(steps[:, seg], SUB_ROWS, dim=1)


def _chunks(rows: int):
    return [slice(r, min(r + CHUNK_ROWS, rows))
            for r in range(0, rows, CHUNK_ROWS)]


def pack_codes(layout, payload: torch.Tensor, steps: torch.Tensor,
               bits: int, comm: torch.Tensor):
    """Stacked dequantized payload → (codes, steps) wire tensors.

    ``payload`` is the (W, rows, 128) float32 buffer, ``steps`` the true
    encode quantizer steps (``aux["wire_steps"]``, (W, num_leaves)
    float32), ``comm`` masks quiet workers to all-zero slots.  ``codes`` is
    ``(W, rows/k, 128)`` uint8 with k = 8/width codes a byte (rows is a
    multiple of 256, so k ∈ {1, 2, 4} divides every chunk), or ``(W, rows,
    128)`` uint16 above 8 bits; code j of a byte is row ``k·r + j`` in its
    bits ``j·width``, as the reference packs.

    Code recovery ``round(payload·(1/step))`` tolerates the fresh 1/step
    reciprocal: payload = code·step exactly, so the relative error is a
    few ulps and |code| ≤ 32767 keeps the absolute error far below the
    0.5 rounding margin.
    """
    qmax = float(2 ** (bits - 1) - 1)
    W, rows = payload.shape[0], layout.rows
    m = comm.reshape(-1).to(torch.float32)
    stw = steps * m[:, None]
    width = wire_code_width(bits)
    k = 1 if width == 16 else 8 // width
    store = torch.uint16 if width == 16 else torch.uint8
    out = torch.empty((W, rows // k, LANES), dtype=store,
                      device=payload.device)
    for rs in _chunks(rows):
        step_rows = _step_rows(layout, stw, rs)
        inv = torch.where(step_rows > 0.0, 1.0 / torch.where(
            step_rows > 0.0, step_rows, torch.ones_like(step_rows)),
            torch.zeros_like(step_rows))
        codes = torch.clamp(torch.round(payload[:, rs].float()
                                        * inv[:, :, None]), -qmax, qmax)
        biased = codes.add_(qmax).mul_(m[:, None, None])
        if width == 16:
            out[:, rs] = biased.to(store)
            continue
        b4 = biased.to(store).reshape(W, -1, k, LANES)
        packed = b4[:, :, 0, :].clone()
        for j in range(1, k):
            packed |= b4[:, :, j, :] << (j * width)
        out[:, rs.start // k:rs.stop // k] = packed
        del codes, biased, b4, packed
    return out, stw


def unpack_codes(layout, codes: torch.Tensor, steps: torch.Tensor,
                 bits: int, rows: Optional[slice] = None,
                 device=None) -> torch.Tensor:
    """Gathered (D, …) wire tensors → (D, rows, 128) float32 payload
    buffers — equal to the payloads :func:`pack_codes` consumed.  ``rows``
    (whole 256-row blocks) unpacks those rows alone; ``device`` moves the
    codes of those rows and the steps there first."""
    qmax = float(2 ** (bits - 1) - 1)
    width = wire_code_width(bits)
    rs = slice(0, layout.rows) if rows is None else rows
    if rs.start % BLOCK_ROWS or (rs.stop % BLOCK_ROWS
                                 and rs.stop != layout.rows):
        raise ValueError(f"rows {rs} must cover whole {BLOCK_ROWS}-row "
                         f"blocks")
    k = 1 if width == 16 else 8 // width
    part = codes[:, rs.start // k:rs.stop // k]
    if device is not None:
        part, steps = part.to(device), steps.to(device)
    D = part.shape[0]
    if width == 16:
        fields = part.to(torch.float32)
    else:
        mask = (1 << width) - 1
        fields = torch.stack([(part >> (j * width)) & mask
                              for j in range(k)], dim=2).reshape(
            D, rs.stop - rs.start, LANES).to(torch.float32)
    step_rows = _step_rows(layout, steps, rs)          # (D, rows)
    return fields.sub_(qmax).mul_(step_rows[:, :, None])


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

    # -- the collective wire format (repro_torch.devrun) ---------------------

    def wire_pack(self, layout, payload, aux: Dict[str, Any],
                  comm: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Packed b-bit codes + per-leaf quantizer steps instead of the
        float32 buffer — what a triggered LAQ upload is on the wire."""
        if "wire_steps" not in aux:
            raise ValueError(
                "LAQ wire_pack needs the encode's quantizer steps in "
                "aux['wire_steps'] (threaded by LAQPolicy.encode / "
                f"fast_precompute) — got aux keys {sorted(aux)}")
        codes, steps = pack_codes(layout, payload, aux["wire_steps"],
                                  self.bits, comm)
        return {"codes": codes, "steps": steps}

    def wire_unpack(self, layout, wire: Dict[str, torch.Tensor], *,
                    rows: Optional[slice] = None, device=None
                    ) -> torch.Tensor:
        return unpack_codes(layout, wire["codes"], wire["steps"], self.bits,
                            rows=rows, device=device)

    def wire_slot_bytes(self, layout) -> Dict[str, int]:
        width = wire_code_width(self.bits)
        code_bytes = layout.rows * LANES * 2 if width == 16 \
            else (layout.rows // (8 // width)) * LANES
        return {"codes": code_bytes, "steps": layout.num_leaves * 4}
