"""Model assembly for the architectures whose layers are all of the
``dense`` kind (llama3.2-1b/-3b/-1b-sw, granite-8b, command-r-35b,
qwen2-vl-7b, hubert-xlarge): embeddings (token lookup, the VLM's vision
prefix, or hubert's audio frames) → stacked blocks → tied or untied head —
port of ``repro.models.model``.

Parameters keep the reference's tree: ``params["blocks"]["0"]`` holds every
layer's weights STACKED along a leading (num_layers,) axis (the reference
scans over it), so the leaf count and LAQ's per-leaf quantizer grid match;
``forward`` unbinds the stack once and loops over the layers.  The decode
cache keeps the reference's tree too: ``cache["blocks"]["0"]["k"]`` is
(num_layers, B, L, KV, hd).

``cfg.use_pallas`` routes as the reference does: the prefill/forward
RMSNorms and attention go through the kernels, the decode step's norms do
not, and LayerNorm has no kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.models import attention, common, mlp, rope
from repro_torch.models.common import ModelConfig

#: the layer kinds the port has
PORTED_KINDS = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    """Every layer kind must be ``dense`` (no MoE, SSD, RG-LRU or local
    attention layer yet), with no unscanned tail."""
    missing = sorted(set(cfg.block_pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: layer kinds {missing} are not ported (the port "
            f"has {list(PORTED_KINDS)})")
    if cfg.tail_layers:
        raise NotImplementedError(
            f"{cfg.arch_id}: an unscanned tail of {cfg.tail_layers} layers "
            f"is not ported")


def _is_shape(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(i, int) for i in s)


def _norm_shapes(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": (d,), "bias": (d,)}
    return {"scale": (d,)}


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree's leaf shapes (the reference ``init``'s tree)."""
    _check_family(cfg)
    L, d = cfg.num_superblocks, cfg.d_model
    layer = {"norm1": _norm_shapes(cfg), "attn": attention.shapes(cfg),
             "norm2": _norm_shapes(cfg), "mlp": mlp.shapes(cfg)}
    tree = {"blocks": {"0": tree_map(lambda s: (L,) + s, layer,
                                     is_leaf=_is_shape)},
            "tail": [],
            "final_norm": _norm_shapes(cfg)}
    if cfg.family == "audio":
        tree["mask_emb"] = (d,)
    else:
        tree["embed"] = (cfg.vocab_size, d)
    if not cfg.tie_embeddings:
        tree["head"] = (d, cfg.vocab_size)
    return tree


def templates(cfg: ModelConfig) -> Dict:
    """Shape-only (meta) tensors of the parameter tree."""
    dt = cfg.params_dtype
    return tree_map(lambda s: torch.empty(s, dtype=dt, device="meta"),
                    param_shapes(cfg), is_leaf=_is_shape)


def init_(params: Dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Random init, in place, from ``gen`` (on the params' device): the
    reference's distributions — normal·0.02 embeddings, truncated-normal
    fan-in projections and head, unit norm scales, zero biases and
    ``mask_emb``."""
    d = cfg.d_model
    blk = params["blocks"]["0"]
    fan_in = {"wq": d, "wk": d, "wv": d,
              "wo": cfg.num_heads * cfg.head_dim,
              "w_up": d, "w_gate": d, "w_down": cfg.d_ff}
    norms = [blk["norm1"], blk["norm2"], params["final_norm"]]
    with torch.no_grad():
        if "embed" in params:
            common.embed_init_(params["embed"], gen)
        for group in ("attn", "mlp"):
            for name, t in blk[group].items():
                if name in fan_in:
                    common.dense_init_(t, fan_in[name], gen)
                else:                                  # a bias
                    t.zero_()
        if "head" in params:
            common.dense_init_(params["head"], d, gen)
        if "mask_emb" in params:
            params["mask_emb"].zero_()
        for p in norms:
            p["scale"].fill_(1.0)
            if "bias" in p:
                p["bias"].zero_()


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


def _lookup(params: Dict, cfg: ModelConfig, tokens: torch.Tensor):
    return F.embedding(tokens.long(), params["embed"]).to(cfg.compute_dtype)


def _embed(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """(B, S, d): hubert's frames with ``mask_emb`` where ``mask``; else the
    token lookup, after the VLM's ``vision_embeds`` prefix when given."""
    dt = cfg.compute_dtype
    if cfg.family == "audio":
        x = inputs["frames"].to(dt)
        if "mask" in inputs:
            x = torch.where(inputs["mask"][..., None],
                            params["mask_emb"].to(dt), x)
        return x
    x = _lookup(params, cfg, inputs["tokens"])
    if cfg.family == "vlm" and "vision_embeds" in inputs:
        x = torch.cat([inputs["vision_embeds"].to(dt), x], dim=1)
    return x


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].t() if cfg.tie_embeddings else params["head"]
    return x @ head.to(x.dtype)


def _rope(cfg: ModelConfig, inputs: Dict, B: int, S: int, device):
    """(cos, sin, positions): none under ``rope="none"``; M-RoPE from
    ``positions3`` (default arange on all three components, positions its
    first); else RoPE from ``positions`` (default arange)."""
    if cfg.rope == "none":
        return None, None, None
    if cfg.rope == "mrope":
        pos3 = inputs.get("positions3")
        if pos3 is None:
            pos3 = torch.arange(S, device=device)[None, None].expand(3, B, S)
        cos, sin = rope.mrope_angles(pos3, cfg.head_dim, cfg.rope_theta)
        return cos, sin, pos3[0]
    positions = inputs.get("positions")
    if positions is None:
        positions = torch.arange(S, device=device)[None].expand(B, S)
    cos, sin = rope.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    return cos, sin, positions


def forward(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab)."""
    _check_family(cfg)
    x = _embed(params, cfg, inputs)
    B, S, _ = x.shape
    cos, sin, positions = _rope(cfg, inputs, B, S, x.device)
    for p in _layers(params["blocks"]["0"], cfg.num_superblocks):
        x, _ = layer_apply(p, x, cfg, cos=cos, sin=sin, positions=positions)
    x = common.apply_norm(params["final_norm"], x, cfg.norm,
                          use_pallas=cfg.use_pallas)
    return _head(params, cfg, x)


def prefill(params: Dict, cfg: ModelConfig, inputs: Dict, max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Cache-building prefill: the full forward that also returns the
    decode cache, so decoding continues at pos = S.  → (last-position
    logits (B, vocab), cache)."""
    _check_family(cfg)
    x = _embed(params, cfg, inputs)
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
    return _head(params, cfg, x[:, -1]), {"blocks": {"0": stacked},
                                          "tail": []}


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
    if cfg.family == "audio":
        raise ValueError(f"{cfg.arch_id}: encoder-only architecture has no "
                         f"decode step")
    x = _lookup(params, cfg, tokens)
    blk = cache["blocks"]["0"]
    for i, p in enumerate(_layers(params["blocks"]["0"],
                                  cfg.num_superblocks)):
        x, _ = layer_decode(p, x, {"k": blk["k"][i], "v": blk["v"][i]}, pos,
                            cfg)
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    return _head(params, cfg, x), cache


def loss_fn(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Mean cross-entropy over targets ≥ 0; a VLM's vision prefix has
    targets −1."""
    logits = forward(params, cfg, inputs)
    targets = inputs["targets"].long()
    if cfg.family == "vlm" and "vision_embeds" in inputs:
        nv = inputs["vision_embeds"].shape[1]
        pad = torch.full(targets.shape[:1] + (nv,), -1, dtype=targets.dtype,
                         device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    valid = targets >= 0
    tgt = torch.clamp(targets, min=0)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
