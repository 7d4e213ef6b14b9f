"""Plain PyTorch attention (GQA, causal, sliding window): the oracle of the
CUDA flash kernel, and its route for CPU tensors (port of
``repro.kernels.flash_attention.ref``).

The whole softmax over materialised (B, H, Sq, Skv) logits; any Sq and
Skv (the kernel masks ragged lengths itself, so no padded lengths are
needed here).  Differentiable.
"""
import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, scale=None) -> torch.Tensor:
    """q (B,S,H,hd); k,v (B,Skv,KV,hd); returns (B,S,H,hd).  ``scale``
    defaults to hd ** -0.5 (operands zero-padded along hd keep their true
    one)."""
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qpk = H // KV
    if qpk > 1:
        k = torch.repeat_interleave(k, qpk, dim=2)
        v = torch.repeat_interleave(v, qpk, dim=2)
    logits = torch.einsum("bqhk,bshk->bhqs", q, k).to(torch.float32)
    logits = logits * (hd ** -0.5 if scale is None else scale)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((S, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None, None], logits,
                         torch.full((), -1e30, device=q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", w.to(v.dtype), v)
