"""Model assembly: embeddings (token lookup, the VLM's vision prefix, or
hubert's audio frames) → scanned superblocks → the unscanned tail → tied
or untied head — port of ``repro.models.model`` for the layer kinds

  dense  — preLN attention + preLN MLP   (llama, granite, command-r,
                                          qwen2-vl, hubert)
  lattn  — preLN sliding-window attention + preLN MLP  (recurrentgemma)
  rec    — preLN RG-LRU block + preLN MLP              (recurrentgemma)
  ssd    — preLN Mamba-2 SSD mixer                     (mamba2)
  moe    — preLN attention + preLN MoE FFN             (qwen3-moe)

and refuses any other kind by name.

Parameters keep the reference's tree: ``params["blocks"][str(i)]`` holds
the weights of pattern position i of every superblock STACKED along a
leading (num_superblocks,) axis (the reference scans over it), and
``params["tail"]`` is a list of the ``tail_layers`` per-layer dicts of
kind ``pattern[j % len(pattern)]`` (recurrentgemma's 38 = 12 · 3 + 2), so
the leaf count and order, and LAQ's per-leaf quantizer grid, match.
``forward`` unbinds each stack once and loops over the layers.  The decode
cache keeps the reference's tree too: ``{"blocks": {str(i): stacked
per-kind cache}, "tail": [per-layer caches]}`` — K/V for the attention
kinds, (h, conv window) for ``rec``, (conv window, SSM state) for ``ssd``.

``cfg.use_pallas`` routes as the reference does: the prefill/forward
RMSNorms and attention go through the kernels, the decode step's norms do
not, LayerNorm and Mamba-2's gated norm have no kernel.  ``cfg.remat``
(off by default) runs each superblock of a forward that takes gradients
under ``torch.utils.checkpoint``: its activations are
recomputed in the backward, by the same ops in the same order, so losses
and gradients equal those without it bit for bit.  The ``moe``
layers' load-balance losses are summed over the layers and added to the
cross-entropy by ``loss_fn`` (× 0.01, the reference's weight); ``forward``
returns the logits alone.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_map
from repro_torch.models import (attention, common, mamba2, mlp, moe, rglru,
                                rope)
from repro_torch.models.common import ModelConfig

#: the layer kinds the port has
PORTED_KINDS = ("dense", "lattn", "rec", "ssd", "moe")
#: the kinds with attention (rotary angles are computed only for these)
ATTN_KINDS = ("dense", "lattn", "moe")
#: leaves kept in float32 whatever ``cfg.param_dtype`` says
FLOAT32_LEAVES = (rglru.FLOAT32_LEAVES + mamba2.FLOAT32_LEAVES
                  + moe.FLOAT32_LEAVES)
#: the load-balance loss's weight in ``loss_fn``
AUX_WEIGHT = 0.01


def _check_family(cfg: ModelConfig) -> None:
    """Every layer kind of the pattern (and so of the tail) must be
    ported: any other kind is refused by name."""
    missing = sorted(set(cfg.block_pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(
            f"{cfg.arch_id}: layer kinds {missing} are not ported (the port "
            f"has {list(PORTED_KINDS)})")


def _is_shape(s) -> bool:
    return isinstance(s, tuple) and all(isinstance(i, int) for i in s)


def _norm_shapes(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": (d,), "bias": (d,)}
    return {"scale": (d,)}


def layer_shapes(kind: str, cfg: ModelConfig) -> Dict:
    """One layer's leaf shapes (the reference's ``layer_init`` tree)."""
    if kind == "ssd":
        return {"norm1": _norm_shapes(cfg), "mixer": mamba2.shapes(cfg)}
    mixer = ({"rec": rglru.shapes(cfg)} if kind == "rec"
             else {"attn": attention.shapes(cfg)})
    ffn = ({"moe": moe.shapes(cfg)} if kind == "moe"
           else {"mlp": mlp.shapes(cfg)})
    return {"norm1": _norm_shapes(cfg), **mixer, "norm2": _norm_shapes(cfg),
            **ffn}


def _kinds(cfg: ModelConfig):
    """(kind, where) of every layer in order: the superblocks' ("blocks",
    str(i), superblock), then the tail's ("tail", j)."""
    pat = cfg.block_pattern
    for sb in range(cfg.num_superblocks):
        for i, kind in enumerate(pat):
            yield kind, ("blocks", str(i), sb)
    for j in range(cfg.tail_layers):
        yield pat[j % len(pat)], ("tail", j)


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree's leaf shapes (the reference ``init``'s tree)."""
    _check_family(cfg)
    nsb, pat, d = cfg.num_superblocks, cfg.block_pattern, cfg.d_model
    tree = {"blocks": {str(i): tree_map(lambda s: (nsb,) + s,
                                        layer_shapes(kind, cfg),
                                        is_leaf=_is_shape)
                       for i, kind in enumerate(pat)},
            "tail": [layer_shapes(pat[j % len(pat)], cfg)
                     for j in range(cfg.tail_layers)],
            "final_norm": _norm_shapes(cfg)}
    if cfg.family == "audio":
        tree["mask_emb"] = (d,)
    else:
        tree["embed"] = (cfg.vocab_size, d)
    if not cfg.tie_embeddings:
        tree["head"] = (d, cfg.vocab_size)
    return tree


def _template(node, name: str, dt: torch.dtype):
    if _is_shape(node):
        return torch.empty(node, device="meta", dtype=torch.float32
                           if name in FLOAT32_LEAVES else dt)
    if isinstance(node, list):
        return [_template(c, name, dt) for c in node]
    return {k: _template(v, k, dt) for k, v in node.items()}


def templates(cfg: ModelConfig) -> Dict:
    """Shape-only (meta) tensors of the parameter tree, in
    ``cfg.params_dtype`` but for the float32 leaves."""
    return _template(param_shapes(cfg), "", cfg.params_dtype)


def _layer_init_(p: dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    for name, init in (("attn", attention.init_), ("rec", rglru.init_),
                       ("mlp", mlp.init_), ("mixer", mamba2.init_),
                       ("moe", moe.init_)):
        if name in p:
            init(p[name], cfg, gen)
    for name in ("norm1", "norm2"):
        if name in p:
            p[name]["scale"].fill_(1.0)
            if "bias" in p[name]:
                p[name]["bias"].zero_()


def init_(params: Dict, cfg: ModelConfig, gen: torch.Generator) -> None:
    """Random init, in place, from ``gen`` (on the params' device): the
    reference's distributions — normal·0.02 embeddings, truncated-normal
    fan-in projections and head, each kind's own leaves (``rglru.init_``,
    ``mamba2.init_``, ``moe.init_``), unit norm scales, zero biases and
    ``mask_emb``."""
    with torch.no_grad():
        if "embed" in params:
            common.embed_init_(params["embed"], gen)
        for i in sorted(params["blocks"], key=int):
            _layer_init_(params["blocks"][i], cfg, gen)
        for p in params["tail"]:
            _layer_init_(p, cfg, gen)
        if "head" in params:
            common.dense_init_(params["head"], cfg.d_model, gen)
        if "mask_emb" in params:
            params["mask_emb"].zero_()
        params["final_norm"]["scale"].fill_(1.0)
        if "bias" in params["final_norm"]:
            params["final_norm"]["bias"].zero_()


def init(cfg: ModelConfig, *, device, seed: int = 0) -> Dict:
    """A fresh parameter tree on ``device``, one tensor per leaf, drawn by
    :func:`init_` from a generator seeded with ``seed``."""
    params = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device=device), templates(cfg))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_(params, cfg, gen)
    return params


def _unbind(tree, n: int):
    """Per-superblock slices of a stacked tree (one unbind per leaf, so the
    backward stacks each leaf's gradient once)."""
    unb = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda parts: parts[i], unb,
                     is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n)]


def _layers(params: Dict, cfg: ModelConfig):
    """(layer params, kind, where) of every layer in order."""
    nsb = cfg.num_superblocks
    stacks = {i: _unbind(t, nsb) for i, t in params["blocks"].items()}
    for kind, where in _kinds(cfg):
        p = (stacks[where[1]][where[2]] if where[0] == "blocks"
             else params["tail"][where[1]])
        yield p, kind, where


def _ffn(p: dict, h: torch.Tensor, kind: str, cfg: ModelConfig,
         seq_shards: int):
    """→ (the FFN's output, its load-balance loss: None but for ``moe``)."""
    if kind == "moe":
        return moe.apply(p["moe"], h, cfg, seq_shards=seq_shards)
    return mlp.apply(p["mlp"], h, cfg), None


def layer_apply(p: dict, x: torch.Tensor, kind: str, cfg: ModelConfig, *,
                cos, sin, positions, cache_len=None):
    """→ (x, aux, cache): ``aux`` is an ``moe`` layer's load-balance loss
    (None for the other kinds); ``cache_len`` asks for the layer's decode
    cache filled with this sequence (cache-building prefill), else the
    cache is None."""
    cache = None
    want = cache_len is not None
    h = common.apply_norm(p["norm1"], x, cfg.norm, use_pallas=cfg.use_pallas)
    if kind == "ssd":
        out = mamba2.apply(p["mixer"], h, cfg, return_state=want)
        y, cache = out if want else (out, None)
        return x + y, None, cache
    if kind == "rec":
        out = rglru.apply(p["rec"], h, cfg, return_state=want)
        y, cache = out if want else (out, None)
    elif want:
        y, (k, v) = attention.full_attention(
            p["attn"], h, cfg, cos=cos, sin=sin, positions=positions,
            return_kv=True)
        cache = attention.fill_cache(cfg, k, v, cache_len)
    else:
        y = attention.full_attention(p["attn"], h, cfg, cos=cos, sin=sin,
                                     positions=positions)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg.norm, use_pallas=cfg.use_pallas)
    y, aux = _ffn(p, h2, kind, cfg, cfg.moe_seq_shards)
    return x + y, aux, cache


def layer_cache_init(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     *, device) -> dict:
    if kind == "ssd":
        return mamba2.init_cache(cfg, batch, device=device)
    if kind == "rec":
        return rglru.init_cache(cfg, batch, device=device)
    return attention.init_cache(cfg, batch, max_len, device=device)


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


def _angles(cfg: ModelConfig, inputs: Dict, B: int, S: int, device):
    """The rotary angles, only where the pattern has an attention kind."""
    if any(k in ATTN_KINDS for k in cfg.block_pattern):
        return _rope(cfg, inputs, B, S, device)
    return None, None, None


def _constrain_act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The reference's activation sharding constraint: (B, S, d) pinned
    to batch over ``cfg.act_shard_axes`` (sequence over ``"model"`` under
    ``act_shard_seq``) on the mesh in context (``launch.mesh.
    mesh_context``).  ``()`` is the identity.  With no mesh in context, or
    with an axis the mesh lacks, it raises by name, as the reference's
    ``with_sharding_constraint`` does.  On the host mesh it is a placement
    the values already have, so the identity on them: the row-sharded
    trainer (``dist.row_shards``) feeds each rank its own batch rows, and
    the model axis has one rank."""
    if not cfg.act_shard_axes:
        return x
    from repro_torch.dist.sharding import axis_names
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"act_shard_axes={cfg.act_shard_axes!r} pins activations to the "
            f"mesh in context, and there is none: run the model inside "
            f"launch.mesh.mesh_context(mesh) (the reference's "
            f"with_sharding_constraint raises without a mesh too)")
    want = tuple(cfg.act_shard_axes) + (("model",) if cfg.act_shard_seq
                                        else ())
    missing = [a for a in want if a not in axis_names(mesh)]
    if missing:
        raise ValueError(f"act_shard_axes={cfg.act_shard_axes!r} (act_shard_"
                         f"seq={cfg.act_shard_seq}) names mesh axes "
                         f"{missing} the mesh in context lacks: its axes are "
                         f"{axis_names(mesh)}")
    return x


def forward_with_aux(params: Dict, cfg: ModelConfig, inputs: Dict
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits (B, S, vocab), the layers' summed
    load-balance loss: a float32 zero without an ``moe`` layer).  Under
    ``cfg.remat``, with gradients enabled, each superblock runs under
    ``torch.utils.checkpoint``; the tail never does."""
    _check_family(cfg)
    x = _constrain_act(_embed(params, cfg, inputs), cfg)
    B, S, _ = x.shape
    cos, sin, positions = _angles(cfg, inputs, B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(layers, x, aux):
        for p, kind in layers:
            x, a, _ = layer_apply(p, x, kind, cfg, cos=cos, sin=sin,
                                  positions=positions)
            x = _constrain_act(x, cfg)
            if a is not None:
                aux = aux + a
        return x, aux

    remat = cfg.remat and torch.is_grad_enabled()
    width = len(cfg.block_pattern)
    layers = [(p, kind) for p, kind, _ in _layers(params, cfg)]
    scanned = cfg.num_superblocks * width
    for i in range(0, scanned, width):
        block = layers[i:i + width]
        x, aux = (checkpoint(run, block, x, aux, use_reentrant=False)
                  if remat else run(block, x, aux))
    x, aux = run(layers[scanned:], x, aux)
    x = common.apply_norm(params["final_norm"], x, cfg.norm,
                          use_pallas=cfg.use_pallas)
    return _head(params, cfg, x), aux


def forward(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab)."""
    return forward_with_aux(params, cfg, inputs)[0]


def _stack_caches(per_layer, kind: str, cfg: ModelConfig, batch: int,
                  max_len: int, device) -> dict:
    """One pattern position's caches stacked over the superblocks (a
    zero-length stack when there is no superblock)."""
    if per_layer:
        return {n: torch.stack([c[n] for c in per_layer])
                for n in per_layer[0]}
    return {n: t[None][:0] for n, t in layer_cache_init(
        kind, cfg, batch, max_len, device=device).items()}


def prefill(params: Dict, cfg: ModelConfig, inputs: Dict, max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    """Cache-building prefill: the full forward that also returns the
    decode cache, so decoding continues at pos = S.  → (last-position
    logits (B, vocab), cache)."""
    _check_family(cfg)
    x = _embed(params, cfg, inputs)
    B, S, _ = x.shape
    cos, sin, positions = _angles(cfg, inputs, B, S, x.device)
    blocks = {str(i): [] for i in range(len(cfg.block_pattern))}
    tail = []
    for p, kind, where in _layers(params, cfg):
        x, _, c = layer_apply(p, x, kind, cfg, cos=cos, sin=sin,
                              positions=positions, cache_len=max_len)
        (blocks[where[1]] if where[0] == "blocks" else tail).append(c)
    x = common.apply_norm(params["final_norm"], x, cfg.norm,
                          use_pallas=cfg.use_pallas)
    cache = {"blocks": {i: _stack_caches(cs, cfg.block_pattern[int(i)], cfg,
                                         B, max_len, x.device)
                        for i, cs in blocks.items()},
             "tail": tail}
    return _head(params, cfg, x[:, -1]), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> Dict:
    """A zeroed decode cache in the reference's tree."""
    _check_family(cfg)
    nsb, pat = cfg.num_superblocks, cfg.block_pattern
    blocks = {str(i): {n: t[None].expand((nsb,) + t.shape).clone()
                       for n, t in layer_cache_init(
                           kind, cfg, batch, max_len, device=device).items()}
              for i, kind in enumerate(pat)}
    tail = [layer_cache_init(kind, cfg, batch, max_len, device=device)
            for kind, where in _kinds(cfg) if where[0] == "tail"]
    return {"blocks": blocks, "tail": tail}


def layer_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 kind: str, cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """One layer of one decode step; the cache is updated in place.  Its
    norms take the plain route whatever ``cfg.use_pallas`` says: the
    reference's decode calls ``apply_norm`` without the flag."""
    h = common.apply_norm(p["norm1"], x, cfg.norm)
    if kind == "ssd":
        y, cache = mamba2.decode(p["mixer"], h, cache, cfg)
        return x + y, cache
    if kind == "rec":
        y, cache = rglru.decode(p["rec"], h, cache, cfg)
    else:
        y, cache = attention.decode_attention(p["attn"], h, cache, pos, cfg)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg.norm)
    # one token: an moe layer routes B groups of one (C = 1)
    return x + _ffn(p, h2, kind, cfg, 1)[0], cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                tokens: torch.Tensor, pos: int) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens (B, 1) at position ``pos`` → (logits (B, 1,
    vocab), cache).  The cache is updated in place and returned."""
    _check_family(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.arch_id}: encoder-only architecture has no "
                         f"decode step")
    x = _lookup(params, cfg, tokens)
    for p, kind, where in _layers(params, cfg):
        if where[0] == "blocks":
            c = {n: t[where[2]] for n, t in
                 cache["blocks"][where[1]].items()}
        else:
            c = cache["tail"][where[1]]
        x, _ = layer_decode(p, x, c, pos, kind, cfg)
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    return _head(params, cfg, x), cache


def loss_fn(params: Dict, cfg: ModelConfig, inputs: Dict) -> torch.Tensor:
    """Mean cross-entropy over targets ≥ 0 (a VLM's vision prefix has
    targets −1) + 0.01 · the MoE layers' load-balance loss."""
    logits, aux = forward_with_aux(params, cfg, inputs)
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
    ce = torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
    return ce + AUX_WEIGHT * aux
