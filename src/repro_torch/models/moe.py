"""Mixture-of-Experts FFN (Qwen3-MoE: softmax-then-top-k routing with
renormalised gates, SwiGLU experts, no shared expert) — port of
``repro.models.moe``.

Tokens are grouped as the reference groups them: g = batch · seq_shards
groups of S_g = S / seq_shards tokens.  In each group every expert has C =
max(⌈S_g · K · capacity_factor / E⌉, 1) slots, taken by the group's
(token, slot) assignments token-major and slot-minor; an assignment past
its expert's C is dropped.  The reference builds this from one-hot
einsums, whose (g, S_g, K, E, C) capacity one-hot alone is 5.4 GB a layer
at qwen3-moe-30b-a3b's serving shape (batch 4 × 2048).  Here the kept rows
are put straight into an (E, g, C, d) capacity buffer, zero where a slot is
empty: every slot holds at most one token, so the buffer is bitwise the
reference's ``expert_in``.  The experts run as three ``torch.bmm`` over E.
Each slot's output is put back at its (token, slot) row, and the K rows of
a token are summed with their gates.

Nothing is added by scatter.  Both puts write each row at most once: the
dropped assignments and the empty slots all go to one spare row that
nothing reads.  So their backward passes are gathers, and a token's
gradient is the sum of its K gathered rows.

The router runs in float32, ``router`` stays float32 whatever
``param_dtype`` says, and the load-balance loss is Switch's: the density of
each token's top-1 expert × the mean probability × E.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models import common
from repro_torch.models.common import ModelConfig

#: leaves kept in float32 whatever ``cfg.param_dtype`` says
FLOAT32_LEAVES = ("router",)


def shapes(cfg: ModelConfig) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
            "w_down": (E, ff, d)}


def init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Fan-in truncated-normal router and experts, in place (the leaves may
    carry a leading stack axis)."""
    d = cfg.d_model
    common.projections_init_(p, {"router": d, "w_gate": d, "w_up": d,
                                 "w_down": cfg.d_ff}, gen)


def capacity(cfg: ModelConfig, group_len: int) -> int:
    """C: each expert's slots in a group of ``group_len`` tokens."""
    return max(int(math.ceil(group_len * cfg.top_k * cfg.capacity_factor
                             / cfg.num_experts)), 1)


def groups(x: torch.Tensor, seq_shards: int) -> torch.Tensor:
    """(B, S, d) → (B · seq_shards, S / seq_shards, d), the routing groups."""
    B, S, d = x.shape
    if seq_shards < 1 or S % seq_shards:
        raise ValueError(f"moe: sequence length {S} does not split into "
                         f"{seq_shards} shards")
    return x.reshape(B * seq_shards, S // seq_shards, d)


class Routing(NamedTuple):
    probs: torch.Tensor      # (g, S_g, E) float32, softmax over E
    gates: torch.Tensor      # (g, S_g, K) float32, renormalised over K
    experts: torch.Tensor    # (g, S_g, K) int64, by descending probability
    slots: torch.Tensor      # (g, S_g, K) int64, place in its expert's queue
    kept: torch.Tensor       # (g, S_g, K) bool, slots < capacity
    capacity: int


def route(p: dict, xg: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The routing decisions of groups ``xg`` (g, S_g, d).

    The top K come from a stable descending sort over E, so ties go to the
    lower expert index as under ``jax.lax.top_k`` (a zero router picks
    experts 0..K-1).  An assignment's slot is the count of the group's
    earlier assignments to its expert, token-major and slot-minor (the
    reference's cumulative count of the int32 one-hots)."""
    g, Sg, _ = xg.shape
    E, K = cfg.num_experts, cfg.top_k
    probs = torch.softmax(xg.float() @ p["router"], dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[..., :K]
    gates = gates / torch.sum(gates, -1, keepdim=True)
    experts = order[..., :K]
    flat = experts.reshape(g, Sg * K, 1)
    onehot = torch.zeros((g, Sg * K, E), dtype=torch.int32,
                         device=xg.device).scatter_(2, flat, 1)
    slots = torch.cumsum(onehot, 1, dtype=torch.int32).gather(2, flat) - 1
    slots = slots.reshape(g, Sg, K).long()
    C = capacity(cfg, Sg)
    return Routing(probs, gates, experts, slots, slots < C, C)


def _rows(r: Routing, E: int) -> torch.Tensor:
    """Each assignment's row of the flat (E · g · C + 1, d) capacity buffer
    (expert, group, slot); the dropped ones the spare last row."""
    g = r.experts.shape[0]
    C = r.capacity
    gi = torch.arange(g, device=r.experts.device)[:, None, None]
    row = (r.experts * g + gi) * C + r.slots
    return torch.where(r.kept, row, torch.full_like(row, E * g * C))


def dispatch(xg: torch.Tensor, r: Routing, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (the capacity buffer (E, g, C, d) in the compute dtype, zero where
    a slot is empty; each assignment's row of it, flat).  The kept rows of
    ``xg`` go in by one ``index_put_``; its backward gathers them back."""
    g, Sg, d = xg.shape
    E, C = cfg.num_experts, r.capacity
    rows = _rows(r, E)
    buf = xg.new_zeros((E * g * C + 1, d), dtype=cfg.compute_dtype)
    buf = buf.index_put_((rows,), xg.to(cfg.compute_dtype)[:, :, None])
    return buf[:-1].view(E, g, C, d), rows


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig, seq_shards: int = 1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), the load-balance loss, a float32
    scalar)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.top_k
    dt = cfg.compute_dtype
    xg = groups(x, seq_shards)
    g, Sg, _ = xg.shape
    r = route(p, xg, cfg)
    expert_in, rows = dispatch(xg, r, cfg)
    xin = expert_in.reshape(E, g * r.capacity, d)
    h = common.activate(torch.bmm(xin, p["w_gate"].to(dt)),
                        torch.bmm(xin, p["w_up"].to(dt)), "swiglu")
    out = torch.bmm(h, p["w_down"].to(dt))                   # (E, g·C, d)

    # each slot's (token, slot) row; the empty slots the spare last row
    n = g * Sg * K
    owner = torch.full((E * g * r.capacity + 1,), n, dtype=torch.long,
                       device=x.device)
    owner.index_put_((rows.reshape(-1),),
                     torch.arange(n, device=x.device))
    per_slot = out.new_zeros((n + 1, d)).index_put_(
        (owner[:-1],), out.reshape(-1, d))
    w = (r.gates * r.kept).to(dt)
    y = torch.einsum("gskd,gsk->gsd", per_slot[:-1].view(g, Sg, K, d), w)

    top1 = torch.zeros((g, Sg, E), dtype=torch.float32, device=x.device)
    top1.scatter_(2, r.experts[..., :1], 1.0)
    density = torch.mean(torch.sum(top1, 1) / Sg, 0)
    proxy = torch.mean(r.probs.reshape(-1, E), 0)
    aux = torch.sum(density * proxy) * E
    return y.reshape(B, S, d), aux
