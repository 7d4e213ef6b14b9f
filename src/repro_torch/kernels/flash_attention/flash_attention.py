"""Flash attention forward on Hopper: the launch of
``csrc/flash_attention.cu`` (float32) and ``csrc/flash_attention_bf16.cu``
(bfloat16, and float16 from the same source built with
``-DLAG_FLASH_F16``), ports of the Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_padded``.

The CUDA kernels take any Sq and Skv (they mask the ragged edges
themselves, so no length is padded), contiguous operands in the reference's
layout, and any head_dim, as the reference's kernel does.  The kernels are
built for head_dim 64, 80, 128 and 256 (one instantiation each per dtype)
and serve 1 to 256: a smaller head_dim is zero-padded to the next built one
(``pad_head_dim``; zero columns add exactly 0 to q·kᵀ and give zero output
columns, which are sliced off) and keeps its true scale hd ** -0.5.  They
run their products on the tensor cores with float32 accumulators: float32
in split TF32 (three TF32 products per float32 product, float32-accurate,
``mma.sync``, K and V through a ``cp.async`` ring); bfloat16 and float16 on
their tensor cores (``wgmma``; one product for the scores, whose 2-byte
terms are exact, and P·V with P split into three bfloat16 terms, or two
float16 terms scaled by exact powers of two; K and V through TMA; float16
scheduled so that the tensor cores never wait on the softmax,
``INSTANCES_F16``), the output rounded to the 2-byte dtype once (the reference kernel's float32
attention on the widened inputs).  A head_dim above 256 takes the wide
kernel of the same source and dtype (``wide_head_dim``: padded to a
multiple of 8 only), on the same tensor cores in the same arithmetic: a
block's output columns split across warps (float32: 3 or 4 warps of 128
columns per 16 query rows) or warpgroups (2-byte: two of 192 or 256
columns per 64 rows), the scores computed once per key tile as partial
products over each one's columns, added in a fixed order in shared memory;
above head_dim 512 the grid takes slabs of 512 output columns, each block
streaming q's slabs with K's.  They have no backward, like the reference's
kernel: an input that requires grad raises.  ``LAUNCHES`` counts the
launches of each kernel and dtype (``flash_attention``,
``flash_attention_bf16``, ``flash_attention_f16``, ``flash_attention_wide``,
``flash_attention_wide_bf16``, ``flash_attention_wide_f16``); nothing else
increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

#: head_dim -> (the columns it is stored as, keys a tile, q's hi fragments
#: in shared memory, warps per 16 query rows): the instantiations of the
#: source (``Hd64``, ``Hd80``, ``Hd128``, ``Hd256``; at 256 two warps
#: share a row group, 128 columns each)
INSTANCES = {64: (64, 64, False, 1), 80: (96, 32, False, 1),
             128: (128, 16, True, 1), 256: (256, 16, True, 2)}

#: the head_dims the kernels are built for (both dtypes)
HEAD_DIMS = tuple(INSTANCES)

#: dynamic shared memory a float32 block takes per head_dim (``SMEM_BYTES``
#: of the source): two K/V ring stages and the lo of the current tile, BK
#: keys x the stored columns each, and q's lo (and hi) fragments (4 row
#: groups x stored/8 k steps x 32 lanes x 4 floats, whatever the warps per
#: group)
SHARED_BYTES = {hd: (3 * 2 * bk * hdp + (2 if qs else 1) * 4 * (hdp // 8)
                     * 32 * 4) * 4
                for hd, (hdp, bk, qs, _) in INSTANCES.items()}

#: the bfloat16 kernel's instantiations (``Hd64`` .. ``Hd256`` of
#: ``flash_attention_bf16.cu``): head_dim -> (keys a tile, consumer
#: warpgroups of 64 query rows a block); every head_dim is stored as 64-column
#: chunks (80: 64 + 16), no padding
INSTANCES_BF16 = {64: (128, 2), 80: (128, 2), 128: (64, 2), 256: (64, 2)}

#: dynamic shared memory a bfloat16 block takes (``Shape::SMEM_BYTES``): 1 KB
#: to align the swizzled tiles, each warpgroup's 64 rows of q, two ring
#: stages of K and V (BK keys each), 64 bytes of mbarriers
SHARED_BYTES_BF16 = {hd: 1024 + wgs * 64 * hd * 2 + 2 * 2 * bk * hd * 2 + 64
                     for hd, (bk, wgs) in INSTANCES_BF16.items()}

#: the float16 kernel's instantiations (``Hd64`` .. ``Hd256`` of the
#: ``-DLAG_FLASH_F16`` build, ``flash_f16_kernel``): head_dim -> (keys a
#: tile, output columns a P·V pass, K/V ring stages, the next tile's
#: scores issued before this tile's P·V); two consumer warpgroups of 64
#: query rows a block, taking turns at the tensor cores.  Each tile's
#: hi·V goes into the running output and its lo·V into a fresh
#: accumulator in one commit group (one wait a pass)
INSTANCES_F16 = {64: (128, 64, 3, True), 80: (128, 80, 3, True),
                 128: (64, 128, 3, True), 256: (64, 64, 2, False)}

#: dynamic shared memory a float16 block takes (``F16Shape::SMEM_BYTES``):
#: 1 KB to align, two warpgroups' 64 rows of q, the ring's stages of K and
#: V, and 1 + 4 mbarriers a stage of 8 bytes (q; K and V full; K and V
#: empty, released apart)
SHARED_BYTES_F16 = {hd: 1024 + 2 * 64 * hd * 2 + st * 2 * bk * hd * 2
                    + 8 * (1 + 4 * st)
                    for hd, (bk, _, st, _) in INSTANCES_F16.items()}

#: the wide kernels' instantiations (head_dim above 256), by the columns a
#: block takes: a head_dim takes the first at or above it, above 512 the
#: grid takes slabs of 512.  float32: 3 or 4 warps of 128 columns per 16
#: query rows, two row groups a block, 16 keys a tile; bfloat16 and
#: float16: two consumer warpgroups of 64 rows x 192 or 256 columns, 32
#: keys a tile
WIDE_HEAD_DIMS = (384, 512)

#: dynamic shared memory a float32 wide block takes (``Wide::SMEM_BYTES``):
#: three ring stages of 16 keys x the columns, and q's hi and lo
#: fragments, 32 rows x the columns each
WIDE_SHARED_BYTES = {oc: (3 * 16 * oc + 2 * 32 * oc) * 4
                     for oc in WIDE_HEAD_DIMS}

#: dynamic shared memory a 2-byte wide block takes (``WideShape::
#: SMEM_BYTES``): 1 KB to align, q's 64 rows, two stages of K and V (32 keys
#: each), the partial scores' exchange (two tile parities x two warpgroups
#: x 128 threads x 16 floats), 128 bytes of mbarriers
WIDE_SHARED_BYTES_BF16 = {oc: 1024 + 64 * oc * 2 + 2 * 2 * 32 * oc * 2
                          + 2 * 2 * 128 * 16 * 4 + 128
                          for oc in WIDE_HEAD_DIMS}

#: each dtype's tensor-core kernel: (its name in ``LAUNCHES``, entry point)
ENTRIES = {torch.float32: ("flash_attention", "lag_flash_attention_f32"),
           torch.bfloat16: ("flash_attention_bf16",
                            "lag_flash_attention_bf16"),
           torch.float16: ("flash_attention_f16", "lag_flash_attention_f16")}
#: each dtype's wide kernel (head_dim above ``HEAD_DIMS[-1]``)
WIDE_ENTRIES = {
    torch.float32: ("flash_attention_wide", "lag_flash_attention_wide_f32"),
    torch.bfloat16: ("flash_attention_wide_bf16",
                     "lag_flash_attention_wide_bf16"),
    torch.float16: ("flash_attention_wide_f16",
                    "lag_flash_attention_wide_f16")}

#: kernel launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for table in (ENTRIES, WIDE_ENTRIES)
                            for name, _ in table.values()}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_float,
         ctypes.c_int, _I64)
_CSRC = Path(__file__).resolve().parent / "csrc"


def _entries(dtype):
    return {ENTRIES[dtype][1]: _ARGS, WIDE_ENTRIES[dtype][1]: _ARGS}


LIBRARY = build.CudaLibrary(
    "flash_attention", _CSRC / "flash_attention.cu", _entries(torch.float32))
LIBRARY_BF16 = build.CudaLibrary(
    "flash_attention_bf16", _CSRC / "flash_attention_bf16.cu",
    _entries(torch.bfloat16))
#: the bfloat16 design on wgmma's .f16 operands: the same source, built
#: again
LIBRARY_F16 = build.CudaLibrary(
    "flash_attention_f16", _CSRC / "flash_attention_bf16.cu",
    _entries(torch.float16), extra_flags=("-DLAG_FLASH_F16",))
#: each dtype's library (its tensor-core kernel and its wide kernel)
LIBRARIES = {torch.float32: LIBRARY, torch.bfloat16: LIBRARY_BF16,
             torch.float16: LIBRARY_F16}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def padded_head_dim(hd: int) -> int:
    """The smallest built head_dim at or above ``hd`` (1 to 256): the
    instantiation a head_dim takes (above 256 the wide kernel takes it,
    ``wide_head_dim``)."""
    for built in HEAD_DIMS:
        if 1 <= hd <= built:
            return built
    raise ValueError(f"flash_attention_fwd: head_dim {hd} not served by "
                     f"the tensor-core kernels (1 to {HEAD_DIMS[-1]}, built "
                     f"for {HEAD_DIMS}; the wide kernel takes any above)")


def wide_head_dim(hd: int) -> int:
    """The head_dim a wide launch takes for ``hd`` above 256: the next
    multiple of 8 (the row stride its copies need); the kernel zero-fills
    the columns past it up to its instantiation's and stores none of
    them."""
    if hd <= HEAD_DIMS[-1]:
        raise ValueError(f"wide_head_dim: head_dim {hd} takes the built "
                         f"instantiations (1 to {HEAD_DIMS[-1]})")
    return -(-hd // 8) * 8


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k, v zero-padded along head_dim to ``padded_head_dim`` (above
    256: ``wide_head_dim``): zero columns add exactly 0 to every q·k and
    give zero output columns, so attention with the true scale on the
    padded operands, cut back to hd columns, is attention on the
    operands."""
    hd = q.shape[-1]
    pad = (wide_head_dim(hd) if hd > HEAD_DIMS[-1]
           else padded_head_dim(hd)) - hd
    if not pad:
        return q, k, v
    return tuple(F.pad(t, (0, pad)) for t in (q, k, v))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) on one CUDA device →
    (B, Sq, H, hd)."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"flash_attention_fwd: CUDA operands on one device "
                         f"required, got {[str(t.device) for t in (q, k, v)]}")
    if q.dtype not in ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: float32, bfloat16 or float16 "
                        f"q, k, v of one dtype required, got "
                        f"{[t.dtype for t in (q, k, v)]}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_fwd has no backward (nor has the "
                           "reference's kernel): call it under no_grad")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_fwd: want q (B,S,H,hd), k/v "
                         f"(B,Skv,KV,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not pair (H % KV == 0)")
    if hd < 1:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not served")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got "
                         f"{window}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: operands must be contiguous "
                         "and 16-byte aligned")
    name, entry = (WIDE_ENTRIES if hd > HEAD_DIMS[-1] else
                   ENTRIES)[q.dtype]
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)
    build.launch(getattr(build.load(LIBRARIES[q.dtype]), entry),
                 q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                 Sq, Skv, H, KV, o.shape[-1], float(hd ** -0.5), int(causal),
                 0 if window is None else int(window), device=q.device)
    LAUNCHES[name] += 1
    return o if o.shape[-1] == hd else o[..., :hd].contiguous()
