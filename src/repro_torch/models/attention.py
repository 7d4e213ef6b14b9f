"""GQA attention, full-sequence (train) path — port of
``repro.models.attention``.

The attention itself is the reference's default ``_chunked_attention`` in
plain tensor ops: scores in query chunks so the live logits are (B, H,
q_chunk, S), masks applied with −1e30, softmax in float32.  The Pallas
flash kernel (``use_pallas``) is not ported yet, and no library attention
call stands in for it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import rope
from repro_torch.models.common import ModelConfig


def shapes(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
            "wo": (H, hd, d)}


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _project_qkv(p, x, cfg: ModelConfig, cos, sin):
    dt = cfg.compute_dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    return rope.apply_rotary(q, cos, sin), rope.apply_rotary(k, cos, sin), v


def full_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, cos, sin,
                   positions: Optional[torch.Tensor] = None,
                   q_chunk: int = 512) -> torch.Tensor:
    """Train attention. x (B, S, d) → (B, S, d)."""
    B, S, _ = x.shape
    dt = cfg.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, cos, sin)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    out = _chunked_attention(q, k, v, positions, cfg, q_chunk)
    H, hd, d = p["wo"].shape
    return out.to(dt).reshape(B, S, H * hd) @ p["wo"].to(dt).reshape(H * hd, d)


def _chunked_attention(q, k, v, positions, cfg: ModelConfig, q_chunk: int):
    """Reference attention over query chunks (live logits (B, H, c, S))."""
    B, S, H, hd = q.shape
    if cfg.q_per_kv > 1:                    # GQA: kv head h // q_per_kv
        k = torch.repeat_interleave(k, cfg.q_per_kv, dim=2)
        v = torch.repeat_interleave(v, cfg.q_per_kv, dim=2)
    scale = hd ** -0.5
    q_chunk = min(q_chunk, S)
    n_chunks = -(-S // q_chunk)
    pad = n_chunks * q_chunk - S
    qpos = positions
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = torch.nn.functional.pad(positions, (0, pad), value=-1)
    kpos = positions
    outs = []
    for c in range(n_chunks):
        qc = q[:, c * q_chunk:(c + 1) * q_chunk]             # (B, c, H, hd)
        qp = qpos[:, c * q_chunk:(c + 1) * q_chunk]          # (B, c)
        logits = torch.einsum("bchk,bshk->bhcs", qc, k).to(torch.float32)
        logits = logits * scale
        mask = torch.ones((B, qp.shape[1], S), dtype=torch.bool,
                          device=q.device)
        if cfg.causal:
            mask &= qp[:, :, None] >= kpos[:, None, :]
        mask &= qp[:, :, None] >= 0          # padded queries attend nothing
        logits = torch.where(mask[:, None], logits,
                             torch.full((), -1e30, device=q.device))
        w = torch.softmax(logits, dim=-1).to(qc.dtype)
        outs.append(torch.einsum("bhcs,bshk->bchk", w, v))
    return torch.cat(outs, dim=1)[:, :S]
