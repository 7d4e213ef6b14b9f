"""GQA attention: full-sequence (train/prefill) and single-token decode —
port of ``repro.models.attention``.

The full-sequence path is the reference's default ``_chunked_attention``
in plain tensor ops (scores in query chunks so the live logits are (B, H,
q_chunk, S), masks applied with −1e30, softmax in float32), or, under
``cfg.use_pallas``, the flash kernel (``repro_torch.kernels.
flash_attention``: hand-written CUDA for CUDA tensors, its plain version
for CPU tensors).  No library attention call stands in for either.

The decode cache is the full (non-windowed) one: (B, max_len, KV, hd) per
layer, filled by prefill and written in place by each decode step.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
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


def _out_proj(p, out: torch.Tensor, dt) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    H, hd, d = p["wo"].shape
    return out.to(dt).reshape(out.shape[:-2] + (H * hd,)) \
        @ p["wo"].to(dt).reshape(H * hd, d)


def full_attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *, cos, sin,
                   positions: Optional[torch.Tensor] = None,
                   q_chunk: int = 512, return_kv: bool = False):
    """Train/prefill attention. x (B, S, d) → (B, S, d).

    ``return_kv`` also returns the rotated (k, v) for the cache-filling
    prefill.  Under ``cfg.use_pallas`` the flash kernel takes the causal /
    window masks and ignores ``positions``, as the reference's does.
    """
    B, S, _ = x.shape
    dt = cfg.compute_dtype
    q, k, v = _project_qkv(p, x, cfg, cos, sin)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.use_pallas:
        out = fa_ops.flash_attention(q, k, v, causal=cfg.causal,
                                     window=cfg.window)
    else:
        out = _chunked_attention(q, k, v, positions, cfg, q_chunk)
    y = _out_proj(p, out, dt)
    return (y, (k, v)) if return_kv else y


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


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=None) -> dict:
    """Zeroed KV cache for one attention layer (the full cache: the rolling
    windowed one is not ported)."""
    if cfg.window:
        raise NotImplementedError("the rolling (windowed) cache is not "
                                  "ported yet")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
               max_len: int) -> dict:
    """A decode cache holding a freshly prefilled sequence: k/v (B, S, KV,
    hd) right-padded with zeros to ``max_len``."""
    if cfg.window:
        raise NotImplementedError("the rolling (windowed) cache is not "
                                  "ported yet")
    pad = max_len - k.shape[1]
    if pad < 0:
        raise ValueError(f"prompt of {k.shape[1]} tokens exceeds max_len "
                         f"{max_len}")
    return {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}


def decode_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d), pos → (y (B, 1, d), cache).

    The new K/V row is written IN PLACE at slot ``pos`` of the
    preallocated cache (the reference's ``dynamic_update_slice`` returns a
    new cache); the returned cache is the same dict.  Attention reads the
    written slots 0..pos only, which is the reference's mask of the
    unwritten ones.  GQA groups the query heads per kv head instead of
    repeating K/V.
    """
    pos = int(pos)
    B = x.shape[0]
    dt = cfg.compute_dtype
    Lc = cache["k"].shape[1]
    if not 0 <= pos < Lc:
        raise ValueError(f"decode position {pos} outside the cache (0.."
                         f"{Lc - 1})")
    posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    cos, sin = rope.rope_angles(posb, cfg.head_dim, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(p, x, cfg, cos, sin)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    k = cache["k"][:, :pos + 1].to(q.dtype)          # (B, T, KV, hd)
    v = cache["v"][:, :pos + 1].to(dt)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, KV, cfg.q_per_kv, hd)          # head h = g·qpk + i
    logits = torch.einsum("bgik,btgk->bgit", qg, k)
    logits = (logits * hd ** -0.5).to(torch.float32)
    w = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bgit,btgk->bgik", w, v).reshape(B, 1, -1, hd)
    return _out_proj(p, out, dt), cache
