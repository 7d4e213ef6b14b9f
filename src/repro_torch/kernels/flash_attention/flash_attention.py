"""Flash attention forward on Hopper: the launch of
``csrc/flash_attention.cu`` (port of the Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_padded``).

The CUDA kernel takes any Sq and Skv (it masks the ragged edges itself, so
nothing is padded), float32 or bfloat16, head_dim 64, 80, 128 or 256 (one
instantiation of the templated source each per dtype; any other head_dim
or dtype raises), contiguous operands in the reference's layout.  It runs
both products on the tensor cores with float32 accumulators: in float32 in
split TF32 (three TF32 products per float32 product, float32-accurate); in
bfloat16, whose values TF32 holds exactly, one TF32 product for the scores
and two for P·V, the output rounded to bfloat16 once (the reference
kernel's float32 attention on the widened inputs).  K and V come through a
``cp.async`` ring in shared memory.  It has no backward, like the
reference's kernel: an input that requires grad raises.  ``LAUNCHES``
counts the launches of each dtype's instantiations (``flash_attention``
for float32, ``flash_attention_bf16`` for bfloat16); nothing else
increments it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

#: head_dim -> (the columns it is stored as, keys a tile, q's hi fragments
#: in shared memory, warps per 16 query rows): the instantiations of the
#: source (``Hd64``, ``Hd80``, ``Hd128``, ``Hd256``; at 256 two warps
#: share a row group, 128 columns each)
INSTANCES = {64: (64, 64, False, 1), 80: (96, 32, False, 1),
             128: (128, 16, True, 1), 256: (256, 16, True, 2)}

#: the head_dims the kernel is built for
HEAD_DIMS = tuple(INSTANCES)

#: dynamic shared memory a float32 block takes per head_dim (``SMEM_BYTES``
#: of the source): two K/V ring stages and the lo of the current tile, BK
#: keys x the stored columns each, and q's lo (and hi) fragments (4 row
#: groups x stored/8 k steps x 32 lanes x 4 floats, whatever the warps per
#: group)
SHARED_BYTES = {hd: (3 * 2 * bk * hdp + (2 if qs else 1) * 4 * (hdp // 8)
                     * 32 * 4) * 4
                for hd, (hdp, bk, qs, _) in INSTANCES.items()}

#: the same for bfloat16 (``Layout<S, bf16>::BYTES``): the two ring stages
#: of bfloat16 K and V, the pair's score exchange at head_dim 256 (4 row
#: groups x 2 warps x BK x 16 floats), and q's hi fragments where they live
#: in shared memory (no lo: q is exact in TF32)
SHARED_BYTES_BF16 = {hd: 2 * 2 * bk * hdp * 2
                     + (4 * halves * bk * 16 if halves == 2 else 0) * 4
                     + (4 * (hdp // 8) * 32 * 4 * 4 if qs else 0)
                     for hd, (hdp, bk, qs, halves) in INSTANCES.items()}

#: the instantiations of each dtype: (their name in ``LAUNCHES``, entry point)
ENTRIES = {torch.float32: ("flash_attention", "lag_flash_attention_f32"),
           torch.bfloat16: ("flash_attention_bf16",
                            "lag_flash_attention_bf16")}

#: kernel launches since the last ``reset_launches()``
LAUNCHES: Dict[str, int] = {name: 0 for name, _ in ENTRIES.values()}

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS = (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_float,
         ctypes.c_int, _I64)
LIBRARY = build.CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {entry: _ARGS for _, entry in ENTRIES.values()})


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, Skv, KV, hd) on one CUDA device →
    (B, Sq, H, hd)."""
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"flash_attention_fwd: CUDA operands on one device "
                         f"required, got {[str(t.device) for t in (q, k, v)]}")
    if q.dtype not in ENTRIES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: float32 or bfloat16 q, k, v "
                        f"of one dtype required, got "
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
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {hd} not built "
                         f"(the kernel takes {HEAD_DIMS})")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window must be >= 1, got "
                         f"{window}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: operands must be contiguous "
                         "and 16-byte aligned")
    name, entry = ENTRIES[q.dtype]
    o = torch.empty_like(q)
    build.launch(getattr(build.load(LIBRARY), entry), q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Skv, H, KV,
                 hd, float(hd ** -0.5), int(causal),
                 0 if window is None else int(window), device=q.device)
    LAUNCHES[name] += 1
    return o
