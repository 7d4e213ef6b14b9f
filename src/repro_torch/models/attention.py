"""GQA attention: full-sequence (train/prefill) and single-token decode —
port of ``repro.models.attention``.

The full-sequence path is the reference's default ``_chunked_attention``
in plain tensor ops (scores in query chunks so the live logits are (B, H,
q_chunk, S), masks applied with −1e30, softmax in float32), or, under
``cfg.use_pallas``, the flash kernel (``repro_torch.kernels.
flash_attention``: hand-written CUDA for CUDA tensors, its plain version
for CPU tensors).  No library attention call stands in for either.

The decode cache is (B, L, KV, hd) per layer, filled by prefill and
written in place by each decode step: L = max_len for full attention, and
under a sliding window the rolling buffer of L = min(window, max_len)
slots, position p at slot p % L, as the reference lays it out.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import common, rope
from repro_torch.models.common import ModelConfig


def shapes(cfg: ModelConfig) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = {"wq": (d, H, hd), "wk": (d, KV, hd), "wv": (d, KV, hd),
           "wo": (H, hd, d)}
    if cfg.use_bias:
        out.update(bq=(H, hd), bk=(KV, hd), bv=(KV, hd))
    return out


def init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Fan-in truncated-normal projections and zero biases, in place (the
    leaves may carry a leading stack axis)."""
    d = cfg.d_model
    common.projections_init_(p, {"wq": d, "wk": d, "wv": d,
                                 "wo": cfg.num_heads * cfg.head_dim}, gen)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(x.shape[:-1] + (h, k))


def _project_qkv(p, x, cfg: ModelConfig, cos, sin):
    dt = cfg.compute_dtype
    q = _proj(x, p["wq"].to(dt))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.rope != "none":
        q = rope.apply_rotary(q, cos, sin)
        k = rope.apply_rotary(k, cos, sin)
    return q, k, v


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
        if cfg.window is not None:
            mask &= (qp[:, :, None] - kpos[:, None, :]) < cfg.window
        mask &= qp[:, :, None] >= 0          # padded queries attend nothing
        logits = torch.where(mask[:, None], logits,
                             torch.full((), -1e30, device=q.device))
        w = torch.softmax(logits, dim=-1).to(qc.dtype)
        outs.append(torch.einsum("bhcs,bshk->bchk", w, v))
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Slots of a layer's cache: the rolling buffer's min(window, max_len)
    under a sliding window, else max_len."""
    return min(cfg.window, max_len) if cfg.window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
               dtype=None) -> dict:
    """Zeroed KV cache for one attention layer."""
    shape = (batch, cache_len(cfg, max_len), cfg.num_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fill_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
               max_len: int) -> dict:
    """A decode cache holding a freshly prefilled sequence, k/v (B, S, KV,
    hd): right-padded with zeros to ``max_len``, or under a window the
    last L = min(window, max_len) rows at slots ``pos % L``."""
    B, S = k.shape[0], k.shape[1]
    L = cache_len(cfg, max_len)
    if not cfg.window:
        if L < S:
            raise ValueError(f"prompt of {S} tokens exceeds max_len "
                             f"{max_len}")
        return {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, L - S)),
                "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, L - S))}
    take = min(L, S)
    slots = torch.arange(S - take, S, device=k.device) % L
    out = {}
    for n, t in (("k", k), ("v", v)):
        buf = torch.zeros((B, L) + tuple(t.shape[2:]), dtype=t.dtype,
                          device=t.device)
        buf[:, slots] = t[:, S - take:]
        out[n] = buf
    return out


def decode_attention(p: dict, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d), pos → (y (B, 1, d), cache).

    The new K/V row is written IN PLACE at slot ``pos % L`` of the
    preallocated cache (the reference's ``dynamic_update_slice`` returns a
    new cache); the returned cache is the same dict.  Before the rolling
    buffer wraps, attention reads the written slots 0..pos only, which is
    the reference's mask of the unwritten ones; once it has wrapped, every
    slot, masked by its absolute position and the window as the reference
    masks it.  The rotary angles are the 1-D ones at ``pos`` whatever
    ``cfg.rope`` says (under M-RoPE too), as in the reference.  GQA groups
    the query heads per kv head instead of repeating K/V.
    """
    pos = int(pos)
    B = x.shape[0]
    dt = cfg.compute_dtype
    Lc = cache["k"].shape[1]
    if pos < 0 or (pos >= Lc and not cfg.window):
        raise ValueError(f"decode position {pos} outside the cache (0.."
                         f"{Lc - 1})")
    cos = sin = None
    if cfg.rope != "none":
        posb = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        cos, sin = rope.rope_angles(posb, cfg.head_dim, cfg.rope_theta)
    q, k_new, v_new = _project_qkv(p, x, cfg, cos, sin)
    slot = pos % Lc
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    wrapped = pos >= Lc
    T = Lc if wrapped else pos + 1
    k = cache["k"][:, :T].to(q.dtype)                # (B, T, KV, hd)
    v = cache["v"][:, :T].to(dt)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, KV, cfg.q_per_kv, hd)          # head h = g·qpk + i
    logits = torch.einsum("bgik,btgk->bgit", qg, k)
    logits = (logits * hd ** -0.5).to(torch.float32)
    if wrapped:
        # slot i holds the largest position p <= pos with p % Lc == i
        idx = torch.arange(Lc, device=x.device)
        abs_pos = pos - torch.remainder(slot - idx, Lc)
        valid = abs_pos <= pos
        if cfg.window is not None:
            valid &= (pos - abs_pos) < cfg.window
        logits = torch.where(valid, logits,
                             torch.full((), -1e30, device=x.device))
    w = torch.softmax(logits, dim=-1).to(dt)
    out = torch.einsum("bgit,btgk->bgik", w, v).reshape(B, 1, -1, hd)
    return _out_proj(p, out, dt), cache
