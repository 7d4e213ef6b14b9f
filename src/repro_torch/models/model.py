"""Model assembly for the dense llama family: embeddings → stacked blocks →
tied head — port of ``repro.models.model``.

Parameters keep the reference's tree: ``params["blocks"]["0"]`` holds every
layer's weights STACKED along a leading (num_layers,) axis (the reference
scans over it), so the leaf count and LAQ's per-leaf quantizer grid match;
``forward`` unbinds the stack once and loops over the layers.  The decode
cache keeps the reference's tree too: ``cache["blocks"]["0"]["k"]`` is
(num_layers, B, max_len, KV, hd).

``cfg.use_pallas`` routes as the reference does: the prefill/forward norms
and attention go through the kernels, the decode step's norms do not.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.models import attention, common, mlp, rope
from repro_torch.models.common import ModelConfig


def _check_family(cfg: ModelConfig) -> None:
    """Only the dense llama family is ported: RMSNorm, RoPE, SwiGLU, no
    biases, no sliding window, tied embeddings, no unscanned tail."""
    ok = (cfg.family == "dense" and set(cfg.block_pattern) == {"dense"}
          and not cfg.tail_layers and cfg.norm == "rmsnorm"
          and cfg.rope == "rope" and cfg.act == "swiglu"
          and not cfg.use_bias and cfg.window is None
          and cfg.tie_embeddings)
    if not ok:
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense llama family is ported")


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree's leaf shapes (the reference ``init``'s tree)."""
    _check_family(cfg)
    L, d = cfg.num_superblocks, cfg.d_model
    layer = {"norm1": {"scale": (d,)}, "attn": attention.shapes(cfg),
             "norm2": {"scale": (d,)}, "mlp": mlp.shapes(cfg)}
    tree = {"embed": (cfg.vocab_size, d),
            "blocks": {"0": tree_map(lambda s: (L,) + s, layer,
                                     is_leaf=lambda s: isinstance(s, tuple)
                                     and all(isinstance(i, int) for i in s))},
            "tail": [],
            "final_norm": {"scale": (d,)}}
    return tree


def templates(cfg: ModelConfig) -> Dict:
    """Shape-only (meta) tensors of the parameter tree."""
    dt = cfg.params_dtype
    return tree_map(lambda s: torch.empty(s, dtype=dt, device="meta"),
                    param_shapes(cfg),
                    is_leaf=lambda s: isinstance(s, tuple)
                    and all(isinstance(i, int) for i in s))


def init_(params: Dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Random init, in place, from ``gen`` (on the params' device): the
    reference's distributions — normal·0.02 embeddings, truncated-normal
    fan-in projections, unit norm scales."""
    d = cfg.d_model
    common.embed_init_(params["embed"], gen)
    blk = params["blocks"]["0"]
    fan_in = {"wq": d, "wk": d, "wv": d,
              "wo": cfg.num_heads * cfg.head_dim,
              "w_up": d, "w_gate": d, "w_down": cfg.d_ff}
    with torch.no_grad():
        for group in ("attn", "mlp"):
            for name, t in blk[group].items():
                common.dense_init_(t, fan_in[name], gen)
        for t in (blk["norm1"]["scale"], blk["norm2"]["scale"],
                  params["final_norm"]["scale"]):
            t.fill_(1.0)


def init(cfg: ModelConfig, *, device, seed: int = 0) -> Dict:
    """A fresh parameter tree on ``device``, one tensor per leaf, drawn by
    :func:`init_` from a generator seeded with ``seed``."""
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device=device), templates(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_(params, cfg, gen)
    return params


def _layers(blocks: Dict, n: int):
    """Per-layer parameter dicts from the stacked tree (one unbind per
    leaf, so the backward stacks each leaf's gradient once)."""
    unb = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda parts: parts[i], unb,
                     is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n)]


def layer_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, cos, sin,
                positions, cache_len=None):
    """→ (x, cache): ``cache_len`` asks for the layer's decode cache filled
    with this sequence (cache-building prefill); else the cache is None."""
    cache = None
    h = common.apply_norm(p["norm1"], x, cfg.norm, use_pallas=cfg.use_pallas)
    if cache_len is not None:
        y, (k, v) = attention.full_attention(
            p["attn"], h, cfg, cos=cos, sin=sin, positions=positions,
            return_kv=True)
        cache = attention.fill_cache(cfg, k, v, cache_len)
    else:
        y = attention.full_attention(p["attn"], h, cfg, cos=cos, sin=sin,
                                     positions=positions)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg.norm, use_pallas=cfg.use_pallas)
    return x + mlp.apply(p["mlp"], h2, cfg), cache


def _embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor):
    return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)


def _head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["embed"].t().to(x.dtype)          # tied head


def _rope(cfg: ModelConfig, inputs: Dict, B: int, S: int, device):
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(S, device=device)[None].expand(B, S)
    cos, sin = rope.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return cos, sin, positions


def forward(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab)."""
    _check_family(cfg)
    x = _embed(params, cfg, inputs["tokens"])
    B, S, _ = x.shape
    cos, sin, positions = _rope(cfg, inputs, B, S, x.device)
    for p in _layers(params["blocks"]["0"], cfg.num_superblocks):
        x, _ = layer_apply(p, x, cfg, cos=cos, sin=sin, positions=positions)
    x = common.apply_norm(params["final_norm"], x, cfg.norm,
                          use_pallas=cfg.use_pallas)
    return _head(params, x)


def prefill(params: Dict, cfg: ModelConfig, inputs: Dict, max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Cache-building prefill: the full forward that also returns the
    decode cache, so decoding continues at pos = S.  → (last-position
    logits (B, vocab), cache)."""
    _check_family(cfg)
    x = _embed(params, cfg, inputs["tokens"])
    B, S, _ = x.shape
    cos, sin, positions = _rope(cfg, inputs, B, S, x.device)
    caches = []
    for p in _layers(params["blocks"]["0"], cfg.num_superblocks):
        x, c = layer_apply(p, x, cfg, cos=cos, sin=sin, positions=positions,
                           cache_len=max_len)
        caches.append(c)
    x = common.apply_norm(params["final_norm"], x, cfg.norm,
                          use_pallas=cfg.use_pallas)
    stacked = {n: torch.stack([c[n] for c in caches]) for n in ("k", "v")}
    return _head(params, x[:, -1]), {"blocks": {"0": stacked}, "tail": []}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Dict:
    """A zeroed decode cache in the reference's tree."""
    _check_family(cfg)
    one = attention.init_cache(cfg, batch, max_len, device=device)
    return {"blocks": {"0": {n: torch.stack([t] * cfg.num_superblocks)
                             for n, t in one.items()}}, "tail": []}


def layer_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One layer of one decode step.  Its norms take the plain route
    whatever ``cfg.use_pallas`` says: the reference's decode calls
    ``apply_norm`` without the flag."""
    h = common.apply_norm(p["norm1"], x, cfg.norm)
    y, cache = attention.decode_attention(p["attn"], h, cache, pos, cfg)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg.norm)
    return x + mlp.apply(p["mlp"], h2, cfg), cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens (B, 1) at position ``pos`` → (logits (B, 1,
    vocab), cache).  The cache is updated in place and returned."""
    _check_family(cfg)
    x = _embed(params, cfg, tokens)
    blk = cache["blocks"]["0"]
    for i, p in enumerate(_layers(params["blocks"]["0"],
                                  cfg.num_superblocks)):
        x, _ = layer_decode(p, x, {"k": blk["k"][i], "v": blk["v"][i]}, pos,
                            cfg)
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    return _head(params, x), cache


def loss_fn(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Mean next-token cross-entropy over targets ≥ 0."""
    logits = forward(params, cfg, inputs)
    targets = inputs["targets"].long()
    valid = targets >= 0
    tgt = torch.clamp(targets, min=0)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
