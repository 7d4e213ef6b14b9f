"""Mamba-2's mixer by the SSD (state-space duality) chunked algorithm, the
``ssd`` layer kind [arXiv:2405.21060] — port of ``repro.models.mamba2``.

The sequence is cut into chunks of Q = ``ssm_chunk`` tokens (S padded to a
chunk multiple, dt zeroed on the padded steps so they leave the state
alone).  Inside a chunk the output is an attention-like masked product;
across chunks a (heads, headdim, d_state) state is carried by a loop over
the chunks.  The recurrence math is float32.  Decode carries (the conv
window, the SSM state), updated in place.

Two departures from the reference's arithmetic, neither of its result:

* the intra-chunk decay masks the exponent, exp(where(q ≥ k, rel, −∞)),
  where the reference masks the product, where(q ≥ k, exp(rel), 0).  The
  values agree; the masked entries' exp(rel) for q < k (rel > 0) never
  exists, so no inf can reach the backward (the reference's is finite at
  init: |rel| ≤ Q · softplus(dt) there);
* the three-operand einsums are written as two steps each, so that the
  largest intermediate is the (B, nc, Q, Q, h) decay (268 MB at 4 × 2048
  with Q 256 and 32 heads).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ModelConfig

#: leaves kept in float32 whatever ``cfg.param_dtype`` says
FLOAT32_LEAVES = ("A_log", "dt_bias", "D")


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def shapes(cfg: ModelConfig) -> dict:
    d, di, ds, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return {"in_proj": (d, 2 * di + 2 * ds + h),      # [z, x, B, C, dt]
            "conv_w": (cfg.ssm_conv, conv_dim(cfg)),
            "conv_b": (conv_dim(cfg),), "A_log": (h,), "dt_bias": (h,),
            "D": (h,), "norm_scale": (di,), "out_proj": (di, d)}


def init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """The reference's distributions, in place: fan-in truncated normals,
    ``conv_w`` normal · 0.1, A_log 0 (A = −1), dt_bias −2 (softplus ≈
    0.13), D 1, a unit norm scale, a zero conv bias."""
    with torch.no_grad():
        common.dense_init_(p["in_proj"], cfg.d_model, gen)
        p["conv_w"].normal_(0.0, 0.1, generator=gen)
        common.dense_init_(p["out_proj"], cfg.d_inner, gen)
        p["conv_b"].zero_()
        p["A_log"].zero_()
        p["dt_bias"].fill_(-2.0)
        p["D"].fill_(1.0)
        p["norm_scale"].fill_(1.0)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, ds = cfg.d_inner, cfg.ssm_state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * ds],
            zxbcdt[..., 2 * di + 2 * ds:])


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of y ⊙ SiLU(z) (plain, as in the reference: no kernel)."""
    y = y * F.silu(z.to(y.dtype))
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps)).to(y.dtype) * scale.to(y.dtype)


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
          return_state: bool = False):
    """Full-sequence SSD, x (B, S, d) → (B, S, d); with ``return_state``
    also the decode cache after the sequence."""
    B, S0, _ = x.shape
    di, ds, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    Q = min(cfg.ssm_chunk, S0)
    pad = (-S0) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    S = S0 + pad
    nc = S // Q
    dt_ = cfg.compute_dtype

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xbc_raw, dtr = _split_proj(cfg, zxbcdt)
    xbc = F.silu(common.causal_conv(xbc_raw, p["conv_w"].to(dt_))
                 + p["conv_b"].to(dt_))
    xs, Bs, Cs = xbc[..., :di], xbc[..., di:di + ds], xbc[..., di + ds:]

    dt = F.softplus(dtr.float() + p["dt_bias"])                  # (B, S, h)
    if pad:
        # padded steps: dt = 0 ⇒ a = 1 and no input, the state passes
        dt = dt * (torch.arange(S, device=x.device) < S0)[None, :, None]
    A = -torch.exp(p["A_log"])                                   # (h,)
    xh = xs.reshape(B, nc, Q, h, hd).float()
    Bc = Bs.float().reshape(B, nc, Q, ds)
    Cc = Cs.float().reshape(B, nc, Q, ds)
    dtc = dt.reshape(B, nc, Q, h)
    cum = torch.cumsum(dtc * A, dim=2)                 # (B, nc, Q, h) ≤ 0
    xdt = xh * dtc[..., None]                          # (B, nc, Q, h, hd)

    # intra-chunk: M[q, k] = C_q · B_k · exp(cum_q − cum_k) for q ≥ k
    G = torch.einsum("bcqs,bcks->bcqk", Cc, Bc)
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, h)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[:, :, None], rel,
                              torch.full((), -torch.inf, device=x.device)))
    del rel
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", G[..., None] * L, xdt)
    del L

    # chunk states, then the scan over chunks
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (B, nc, Q, h)
    states = torch.einsum("bckhp,bcks->bchps", decay_to_end[..., None] * xdt,
                          Bc)                            # (B, nc, h, hd, ds)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B, nc, h)
    H = torch.zeros((B, h, hd, ds), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(H)
        H = chunk_decay[:, c, :, None, None] * H + states[:, c]
    y_inter = torch.einsum("bcqs,bchps->bcqhp", Cc, torch.stack(h_in, 1)) \
        * torch.exp(cum)[..., None]

    y = y_intra + y_inter + p["D"][:, None] * xh          # (B, nc, Q, h, hd)
    y = y.reshape(B, S, di)[:, :S0].to(dt_)
    y = _gated_norm(y, z[:, :S0], p["norm_scale"])
    out = y @ p["out_proj"].to(dt_)
    if not return_state:
        return out
    return out, {"conv": common.conv_window(xbc_raw[:, :S0], cfg.ssm_conv),
                 "state": H}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, *, device, dtype=None) -> dict:
    dtype = dtype or cfg.compute_dtype
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim(cfg)),
                                dtype=dtype, device=device),
            "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state), dtype=torch.float32,
                                 device=device)}


def decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d) → (y (B, 1, d), cache): one O(1) state update; the cache
    is updated in place and returned."""
    B = x.shape[0]
    di, ds, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    dt_ = cfg.compute_dtype
    z, xbc, dtr = _split_proj(cfg, x[:, 0] @ p["in_proj"].to(dt_))
    window = torch.cat([cache["conv"], xbc[:, None]], 1)          # (B, K, C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"].to(dt_))
                 + p["conv_b"].to(dt_))
    xs, Bs, Cs = xbc[:, :di], xbc[:, di:di + ds], xbc[:, di + ds:]
    dt = F.softplus(dtr.float() + p["dt_bias"])                   # (B, h)
    a = torch.exp(dt * -torch.exp(p["A_log"]))
    xh = xs.reshape(B, h, hd).float()
    upd = (dt[:, :, None] * xh)[..., None] * Bs.float()[:, None, None, :]
    state = a[:, :, None, None] * cache["state"] + upd
    y = torch.einsum("bhps,bs->bhp", state, Cs.float())
    y = (y + p["D"][:, None] * xh).reshape(B, di).to(dt_)
    y = _gated_norm(y, z, p["norm_scale"])
    cache["conv"].copy_(window[:, 1:])
    cache["state"].copy_(state)
    return (y @ p["out_proj"].to(dt_))[:, None], cache
