"""Griffin's recurrent block with the Real-Gated LRU (RG-LRU), the ``rec``
layer kind of recurrentgemma [arXiv:2402.19427] — port of
``repro.models.rglru``:

  u  = GELU(x W_y)                         # multiplicative branch
  v  = causal_conv1d(x W_x)                # recurrent branch
  r  = σ(blockdiag(v, W_a) + b_a)          # recurrence gate
  i  = σ(blockdiag(v, W_i) + b_i)          # input gate
  log a_t = c · r_t · log σ(Λ),  c = 8
  h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ v_t)
  y  = (h ⊙ u) W_out

The gates are float32.  The reference runs the linear recurrence with
``jax.lax.associative_scan``; it has no Pallas kernel, and here it is plain
tensor code: :func:`linear_scan`, a log-depth doubling scan over S (its
association order differs from XLA's; the tests state the tolerance).
Decode carries (h, the last ``ssm_conv - 1`` rows of x W_x), updated in
place.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import ModelConfig

_C = 8.0

#: leaves kept in float32 whatever ``cfg.param_dtype`` says
FLOAT32_LEAVES = ("b_a", "b_i", "lam")


def d_rnn(cfg: ModelConfig) -> int:
    return cfg.rglru_expand * cfg.d_model


def n_blocks(cfg: ModelConfig) -> int:
    return max(cfg.num_heads, 1)


def shapes(cfg: ModelConfig) -> dict:
    d, dr, nb = cfg.d_model, d_rnn(cfg), n_blocks(cfg)
    bd = dr // nb
    return {"w_x": (d, dr), "w_y": (d, dr), "conv_w": (cfg.ssm_conv, dr),
            "conv_b": (dr,), "w_a": (nb, bd, bd), "b_a": (dr,),
            "w_i": (nb, bd, bd), "b_i": (dr,), "lam": (dr,),
            "w_out": (dr, d)}


def init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """The reference's distributions, in place (leaves may carry a leading
    stack axis): fan-in truncated normals (the block-diagonal gates at
    fan-in dr / nb), ``conv_w`` normal · 0.1, zero biases, Λ = linspace(2,
    8, dr) so that a = σ(Λ)^c spreads over (0.1, 0.999)."""
    d, dr, nb = cfg.d_model, d_rnn(cfg), n_blocks(cfg)
    with torch.no_grad():
        common.dense_init_(p["w_x"], d, gen)
        common.dense_init_(p["w_y"], d, gen)
        p["conv_w"].normal_(0.0, 0.1, generator=gen)
        common.dense_init_(p["w_a"], dr // nb, gen)
        common.dense_init_(p["w_i"], dr // nb, gen)
        common.dense_init_(p["w_out"], dr, gen)
        for n in ("conv_b", "b_a", "b_i"):
            p[n].zero_()
        p["lam"].copy_(torch.linspace(2.0, 8.0, dr))


def _blockdiag(v: torch.Tensor, w: torch.Tensor, nb: int) -> torch.Tensor:
    """v (..., dr) @ block-diagonal w (nb, bd, bd) → (..., dr)."""
    vb = v.reshape(v.shape[:-1] + (nb, v.shape[-1] // nb))
    return torch.einsum("...nb,nbc->...nc", vb, w.to(v.dtype)).reshape(
        v.shape)


def _gates(p: dict, v: torch.Tensor, nb: int):
    """(log a, √(1 − a²) ⊙ i ⊙ v), float32."""
    v32 = v.float()
    r = torch.sigmoid(_blockdiag(v32, p["w_a"], nb) + p["b_a"])
    i = torch.sigmoid(_blockdiag(v32, p["w_i"], nb) + p["b_i"])
    log_a = _C * r * F.logsigmoid(p["lam"])                # ≤ 0
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, beta * (i * v32)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t along axis 1 from h_{−1} = 0.

    A doubling (Hillis–Steele) scan: after the step of span k, entry t
    holds the composition of the steps (t − 2k, t]; ⌈log2 S⌉ steps of a
    few elementwise passes, out of place (autograd runs through it).  At
    recurrentgemma's (2, 4096, 4096) serving shape a and b are 134 MB
    each, and a step holds about four such tensors at once; a sequential
    loop would launch S steps of tiny kernels instead.  Running products of
    a underflow to 0 over long spans (a ≥ 0.36 at Λ = 2): such terms are
    below float32's resolution of h anyway."""
    S = a.shape[1]
    k = 1
    while k < S:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], 1)
        if 2 * k < S:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], 1)
        k *= 2
    return b


def apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
          return_state: bool = False):
    """Full-sequence recurrent block, x (B, S, d) → (B, S, d); with
    ``return_state`` also the decode cache after the sequence."""
    dt = cfg.compute_dtype
    nb = n_blocks(cfg)
    u = F.gelu(x @ p["w_y"].to(dt), approximate="tanh")
    vx = x @ p["w_x"].to(dt)
    v = common.causal_conv(vx, p["conv_w"].to(dt)) + p["conv_b"].to(dt)
    log_a, b = _gates(p, v, nb)
    h = linear_scan(torch.exp(log_a), b)
    y = (h.to(dt) * u) @ p["w_out"].to(dt)
    if not return_state:
        return y
    return y, {"h": h[:, -1].float(),
               "conv": common.conv_window(vx, p["conv_w"].shape[0])}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, *, device, dtype=None) -> dict:
    dtype = dtype or cfg.compute_dtype
    dr = d_rnn(cfg)
    return {"h": torch.zeros((batch, dr), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, dr), dtype=dtype,
                                device=device)}


def decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, dict]:
    """x (B, 1, d) → (y (B, 1, d), cache); the cache is updated in place
    and returned."""
    dt = cfg.compute_dtype
    u = F.gelu(x[:, 0] @ p["w_y"].to(dt), approximate="tanh")
    vx = x[:, 0] @ p["w_x"].to(dt)
    window = torch.cat([cache["conv"], vx[:, None]], 1)
    v = torch.einsum("bkc,kc->bc", window, p["conv_w"].to(dt)) \
        + p["conv_b"].to(dt)
    log_a, b = _gates(p, v, n_blocks(cfg))
    h = torch.exp(log_a) * cache["h"] + b
    y = ((h.to(dt) * u) @ p["w_out"].to(dt))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return y, cache
