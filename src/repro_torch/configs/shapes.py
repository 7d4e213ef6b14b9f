"""The input shapes, their applicability rule, the VLM's vision prefix and
the inputs' stand-ins — port of ``repro.configs.shapes`` as far as the
launchers, the data path and the dry-run need it (``applicable``,
``vision_prefix``, ``input_specs``: meta tensors, no allocation).

  train_4k     seq 4,096    global_batch 256   train_step
  prefill_32k  seq 32,768   global_batch 32    forward (prefill)
  decode_32k   seq 32,768   global_batch 128   serve_step (1 token, 32k cache)
  long_500k    seq 524,288  global_batch 1     serve_step (1 token, 500k ctx)

Encoder-only archs have no decode shapes; long_500k needs a sub-quadratic
sequence mixer (ssd / rec layers or a sliding window).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def subquadratic(cfg: ModelConfig) -> bool:
    """True iff every sequence mixer is O(S·window) or better."""
    for k in cfg.block_pattern:
        if k in ("ssd", "rec", "lattn"):
            continue                      # recurrent / windowed by definition
        if k in ("dense", "moe") and cfg.window is None:
            return False                  # full attention
    return True


def applicable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    shp = SHAPES[shape_name]
    if shp.kind == "decode" and cfg.family == "audio":
        return False, "encoder-only architecture has no decode step"
    if shape_name == "long_500k" and not subquadratic(cfg):
        return False, ("pure full-attention arch; long_500k needs "
                       "sub-quadratic mixer")
    return True, ""


def vision_prefix(cfg: ModelConfig, seq_len: int) -> int:
    """Number of stub vision-patch positions for VLM shapes (S//4)."""
    return seq_len // 4 if cfg.family == "vlm" else 0


def input_specs(cfg: ModelConfig, shape_name: str,
                batch: Optional[int] = None, seq: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of ``shape_name`` (no
    allocation), in the data path's dtypes: the reference's
    ``input_specs``.  ``batch`` / ``seq`` override the shape's global
    batch and sequence length.  A decode shape's ``pos`` is a Python int,
    as ``model.decode_step`` takes it."""
    shp = SHAPES[shape_name]
    B, S = batch or shp.global_batch, seq or shp.seq_len
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    i32, f = torch.int32, cfg.compute_dtype
    if shp.kind == "decode":
        return {"tokens": meta((B, 1), i32), "pos": S - 1}
    if cfg.family == "audio":
        specs = {"frames": meta((B, S, cfg.d_model), f),
                 "mask": meta((B, S), torch.bool)}
        if shp.kind == "train":
            specs["targets"] = meta((B, S), i32)
        return specs
    if cfg.family == "vlm":
        nv = vision_prefix(cfg, S)
        specs = {"tokens": meta((B, S - nv), i32),
                 "vision_embeds": meta((B, nv, cfg.d_model), f),
                 "positions3": meta((3, B, S), i32)}
        if shp.kind == "train":
            specs["targets"] = meta((B, S - nv), i32)
        return specs
    specs = {"tokens": meta((B, S), i32)}
    if shp.kind == "train":
        specs["targets"] = meta((B, S), i32)
    return specs
