"""Shared model machinery: config, initializers, norms, activations — port
of ``repro.models.common`` for the port's layer kinds (``dense``,
``lattn``, ``rec``, ``ssd``, ``moe``).

Models are plain functions over nested dicts of tensors (the reference's
pytree layout, so the flat-buffer layout and LAQ's per-leaf grid agree).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm import ops as rms_ops


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    causal: bool = True
    window: Optional[int] = None     # sliding-window size (local attention)
    rope: str = "rope"               # rope | mrope | none
    rope_theta: float = 500_000.0
    # layer kinds of one superblock, e.g. ("rec", "rec", "lattn"); the
    # remainder of num_layers is an unscanned tail of pattern[j % len]
    block_pattern: Tuple[str, ...] = ("attn",)
    # MoE: on one device ``moe_seq_shards`` still sets the routing groups
    # (g = batch · shards of S / shards tokens each), so the capacity and
    # which tokens are dropped
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_seq_shards: int = 1
    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # RG-LRU
    rglru_expand: int = 1
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "swiglu"              # swiglu | gelu | geglu
    use_bias: bool = False
    tie_embeddings: bool = False
    dtype: str = "float32"           # activation/compute dtype
    param_dtype: str = "float32"
    # recompute each superblock's layers in the backward instead of keeping
    # their activations (``torch.utils.checkpoint``, the reference's
    # ``jax.checkpoint(superblock)``); the unscanned tail is not wrapped,
    # and a forward without gradients (prefill, decode) runs as it is.  Off
    # by default, unlike the reference: losses and gradients are bitwise
    # the same either way, it costs a second forward, and no driven
    # training shape's peak needs it (trees, not activations, fill it)
    remat: bool = False
    # the hand-written kernels (rmsnorm, flash attention) on the prefill
    # path; for CPU tensors their plain versions
    use_pallas: bool = False
    # the reference's mesh and compile knobs, taken for ``get_config``
    # parity.  act_shard_axes pins activations (B, S, d) to batch over those
    # mesh axes (act_shard_seq: sequence over "model" too): () is the
    # identity; any other value needs a mesh in context
    # (``launch.mesh.mesh_context``) whose axes include them, and raises by
    # name without one, as the reference does; on the host mesh the
    # constraint is the identity on values (``models.model._constrain_act``).
    # scan_unroll (a Python loop instead of lax.scan) and embed_onehot (the
    # lookup as one_hot @ embed, for a vocab-sharded table) give the same
    # values in the reference, and the port runs one program for both: a
    # loop and a gather.  No port path vocab-shards a table; on one that
    # does, F.embedding fails in torch 2.13 (a vocab-sharded DTensor table
    # on a model axis of 2: "IndexError: The shape of the mask … does not
    # match", and redistributing its output fails on MaskPartial) where
    # one_hot(tokens) @ table works
    act_shard_axes: Tuple[str, ...] = ()
    act_shard_seq: bool = False
    scan_unroll: bool = False
    embed_onehot: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def num_superblocks(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def tail_layers(self) -> int:
        return self.num_layers - self.num_superblocks * len(self.block_pattern)

    @property
    def d_inner(self) -> int:       # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """A small same-family variant for CPU tests (the reference's)."""
        small = dict(
            num_layers=min(self.num_layers, len(self.block_pattern) * 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=min(self.head_dim, 64) if self.head_dim else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=min(self.ssm_chunk, 32),
            window=min(self.window, 64) if self.window else self.window,
        )
        small.update(kw)
        return self.replace(**small)


# ---------------------------------------------------------------------------
# Initializers (in place, on the tensors' own device)
# ---------------------------------------------------------------------------

def dense_init_(t: torch.Tensor, in_dim: int, gen: torch.Generator) -> None:
    """Truncated-normal fan-in init: std · N(0, 1) cut at ±2 (the
    reference's ``dense_init``; its bits come from ``jax.random`` and are
    carried across by ``repro_torch.weights`` where parity matters)."""
    with torch.no_grad():
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(1.0 / math.sqrt(in_dim))


def projections_init_(p: dict, fan_in: dict, gen: torch.Generator) -> None:
    """In the leaves' order: a fan-in truncated normal for each name in
    ``fan_in`` (name → fan-in), zero for the rest (the biases)."""
    with torch.no_grad():
        for name, t in p.items():
            if name in fan_in:
                dense_init_(t, fan_in[name], gen)
            else:
                t.zero_()


def embed_init_(t: torch.Tensor, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, 0.02, generator=gen)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6,
               use_pallas: bool = False) -> torch.Tensor:
    """RMSNorm (through the kernel under ``use_pallas``) or LayerNorm (no
    kernel, as in the reference; ``jnp.var`` is the population variance)."""
    if kind == "rmsnorm":
        if use_pallas:
            return rms_ops.rmsnorm(x, p["scale"], eps=eps)
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r}")
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"] + p["bias"]


def activate(x_gate: torch.Tensor, x_up: Optional[torch.Tensor],
             act: str) -> torch.Tensor:
    """swiglu / geglu gate the up projection; gelu takes one input.
    ``jax.nn.gelu`` defaults to the tanh approximation, and so does this."""
    if act == "swiglu":
        return F.silu(x_gate) * x_up
    if act == "geglu":
        return F.gelu(x_gate, approximate="tanh") * x_up
    return F.gelu(x_gate, approximate="tanh")


# ---------------------------------------------------------------------------
# The short causal convolution of the recurrent kinds (rec, ssd)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along S: x (B, S, C), w (K, C) →
    Σ_i x[t − K + 1 + i] · w[i], zeros before the start, summed in the
    reference's order."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out


def conv_window(x: torch.Tensor, K: int) -> torch.Tensor:
    """The last K − 1 rows of x (B, S, C), zero-padded in front when S <
    K − 1: the convolution's decode cache after the sequence."""
    S = x.shape[1]
    if S >= K - 1:
        return x[:, S - (K - 1):]
    return F.pad(x, (0, 0, K - 1 - S, 0))
