"""Compare the 2-byte flash kernels and kernel 5 of two (or more) sources on
the card.

Each ``--flash`` source is built twice (bfloat16, and float16 with
``-DLAG_FLASH_F16``), each ``--plane`` source once, all at once; the first
source of each list is the one the others are held to.  For each build:
its kernels' registers and spills (``-Xptxas -v``) and SASS instruction
mix (``cuobjdump -sass``: HGMMA, the wgmma waits WARPGROUP.DEPBAR, BAR,
SYNCS, LDG, SHFL, local memory LDL / STL).  Then, on the same inputs, the
sources in turns (a, b, a, b):

- flash at chip_smoke's eight 18a shapes: bfloat16 bit for bit the first
  source's, float16 within one float16 ulp (+ 1e-6) of the widened
  attention with its P . V in float64 (``chip_smoke.bf16_flash_case``'s
  oracle); CUDA-event means of 10 launches per turn, float16 SDPA beside;
- kernel 5 (``lag_sq_blocks_bf16`` / ``_f16``) at phase 22a's shape (W = 2,
  llama3.2-1b's full width, 4.94 GB): bit for bit the first source's and
  the float32 kernel's on the widened operand; the median and min-max of
  50 single-launch CUDA-event readings per turn, beside
  ``torch.linalg.vector_norm`` (flat, and per 1024-element sub-block).

Needs ``nvcc`` and a card; exits 1 if a check fails:

    git show <commit>:src/repro_torch/kernels/flash_attention/csrc/\\
flash_attention_bf16.cu > build/flash_a.cu
    git show <commit>:src/repro_torch/fastpath/csrc/fastpath_kernels.cu \\
        > build/fastpath_a.cu
    python tools/flash_sq_compare.py \\
        --flash build/flash_a.cu \\
            src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cu \\
        --plane build/fastpath_a.cu src/repro_torch/fastpath/csrc/fastpath_kernels.cu
"""
import argparse
import collections
import dataclasses
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.device import gpu_name_and_power_limit  # noqa: E402
from repro_torch.fastpath import kernels as fp  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402

#: chip_smoke.py's ATTN_BF16: (B, S, H, KV, hd, causal, window)
SHAPES = ((4, 2048, 32, 8, 64, True, None),
          (4, 2048, 24, 8, 128, True, None),
          (4, 2048, 28, 4, 128, True, None),
          (4, 2048, 16, 16, 80, False, None),
          (4, 2048, 64, 8, 128, True, None),
          (2, 4096, 16, 1, 256, True, 2048),
          (4, 2048, 32, 4, 128, True, None),
          (4, 2048, 64, 4, 128, True, None))
#: llama3.2-1b's flat rows (``param_layout(...).rows``), W = 2
PLANE_W = 2
OPS = ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "BAR", "SYNCS",
       "LDG", "SHFL", "MUFU", "F2FP", "HADD2", "FMUL", "FFMA", "FADD",
       "FMNMX", "LDL", "STL")
TF_S = 989e12


def sass_mix(path: Path, keep):
    """{kernel function: (instructions, {op: count})} for the functions
    whose name holds one of ``keep``."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for func in sass.split("Function : ")[1:]:
        name = func.split("\n", 1)[0]
        if not any(k in name for k in keep):
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T\d]\s+)?"
                         r"([A-Z0-9_]+(?:\.[A-Z0-9_]+)*)", func)
        full = collections.Counter(ops)
        base = collections.Counter(o.split(".")[0] for o in ops)
        mix = {}
        for k in OPS:
            n = (sum(v for o, v in full.items() if o.startswith(k))
                 if "." in k else base[k])
            if n:
                mix[k] = n
        out[name] = (len(ops), mix)
    return out


def ptxas_lines(lib, keep):
    """The ptxas report's lines of ``lib``'s kernels named by ``keep``:
    registers, spills, and any warning."""
    rep = build.BUILD_LOG.get(lib.name, {}).get("ptxas", "")
    lines, show = [], False
    for line in rep.splitlines():
        if "Compiling entry function" in line:
            show = any(k in line for k in keep)
        if show or re.search(r"warning|Potential|serializ|C75\d\d",
                             line):
            lines.append(line.strip())
    return lines


def event_ms(fn, n):
    """CUDA-event mean of ``n`` back-to-back launches, after one."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def each_ms(fn, n):
    """``n`` single-launch CUDA-event readings, after one launch."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def steady(xs):
    return (f"median {statistics.median(xs):.4f} ms (min {min(xs):.4f}, max "
            f"{max(xs):.4f}, n {len(xs)})")


def f16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.clamp(e, min=-13) - 11)


def flash_phase(srcs, libs, dev, bad):
    gen = torch.Generator(device=dev).manual_seed(30)
    F = torch.nn.functional
    for B, S, H, KV, hd, causal, window in SHAPES:
        pos = torch.arange(S, device=dev)
        keep = pos[:, None] >= pos[None] if causal else \
            torch.ones((S, S), dtype=torch.bool, device=dev)
        if window is not None:
            keep &= pos[:, None] - pos[None] < window
        flop = 4 * hd * B * H * int(keep.sum())
        bound = flop / TF_S * 1e3
        what = (f"({B}, {S}, {H}/{KV}, {hd}) "
                f"{'causal' if causal else 'non-causal'}"
                + (f" window {window}" if window else ""))
        for dt, sfx in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
            q = torch.randn((B, S, H, hd), device=dev, generator=gen).to(dt)
            k, v = (torch.randn((B, S, KV, hd), device=dev,
                                generator=gen).to(dt) for _ in range(2))
            outs = [torch.empty_like(q) for _ in libs[sfx]]
            fns = []
            for lib, o in zip(libs[sfx], outs):
                entry = getattr(build.load(lib),
                                fa.ENTRIES[dt][1])
                fns.append(lambda e=entry, o=o: build.launch(
                    e, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), B, S, S, H, KV, hd, float(hd ** -0.5),
                    int(causal), 0 if window is None else window,
                    device=dev))
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            checks = []
            if dt == torch.bfloat16:
                for src, o in zip(srcs[1:], outs[1:]):
                    same = torch.equal(o, outs[0])
                    checks.append(f"{Path(src).name} bitwise: {same}")
                    if not same:
                        bad.append(f"flash bf16 {what}: {src} not bit for "
                                   f"bit the first source")
            else:
                want = fa_ref.attention(q.double(), k.double(), v.double(),
                                        causal=causal,
                                        window=window).to(dt).float()
                for src, o in zip(srcs, outs):
                    d = (o.float() - want).abs()
                    ok = bool(torch.isfinite(o).all()) and bool(
                        (d <= f16_ulp(torch.maximum(o.float().abs(),
                                                    want.abs())) + 1e-6)
                        .all())
                    checks.append(f"{Path(src).name} max |Δ| "
                                  f"{float(d.max()):.3e} within: {ok}")
                    if not ok:
                        bad.append(f"flash f16 {what}: {src} beyond one "
                                   f"ulp + 1e-6")
                del want
            t = [event_ms(fn, 10) for fn in fns + fns]
            line = ", ".join(f"{Path(s).name} {t[i]:.4f} / "
                             f"{t[i + len(fns)]:.4f}"
                             for i, s in enumerate(srcs))
            extra = ""
            if dt == torch.float16:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                mask = None if window is None else keep
                lib_ms = event_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True), 10)
                best = min(t[len(fns) - 1], t[-1])
                extra = (f"; SDPA f16 {lib_ms:.4f} ms; bound {bound:.4f} "
                         f"ms, the design's 1 + 2 products "
                         f"{1.5 * bound:.4f} ms = "
                         f"{1.5 * bound / best:.1%} of the last source")
                del qt, kt, vt
            print(f"flash {sfx} {what}: {line} ms (a, b turns){extra} | "
                  + "; ".join(checks))
            del q, k, v, outs, fns
        torch.cuda.empty_cache()


def sq_phase(srcs, libs, dev, bad, rows):
    gen = torch.Generator(device=dev).manual_seed(5)
    N = PLANE_W * rows * 128
    subs = N // 1024
    bound = (N * 2 + subs * 4) / 3.35e12 * 1e3
    for dt, sfx in ((torch.bfloat16, "_bf16"), (torch.float16, "_f16")):
        a = torch.empty((PLANE_W, rows, 128), dtype=dt, device=dev)
        for w in range(PLANE_W):
            a[w].copy_(torch.randn((rows, 128), device=dev, generator=gen))
        outs = [torch.empty((subs,), device=dev) for _ in libs]
        fns = [lambda e=getattr(build.load(lib), "lag_sq_blocks" + sfx),
               o=o: build.launch(e, a.data_ptr(), o.data_ptr(), subs,
                                 device=dev)
               for lib, o in zip(libs, outs)]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        checks = []
        for src, o in zip(srcs[1:], outs[1:]):
            same = torch.equal(o, outs[0])
            checks.append(f"{Path(src).name} bitwise: {same}")
            if not same:
                bad.append(f"sq_blocks{sfx}: {src} not bit for bit the "
                           f"first source")
        # the float32 kernel on the widened operand, in chunks of 2^19 rows
        step = 1 << 19
        for r0 in range(0, rows, step):
            r1 = min(r0 + step, rows)
            wide = fp.sqnorm_blocks(a[:, r0:r1].float().contiguous())
            got = outs[-1].view(PLANE_W, rows // 8)[:, r0 // 8:r1 // 8]
            if not torch.equal(got, wide):
                bad.append(f"sq_blocks{sfx}: the last source not the "
                           f"float32 kernel's on the widened operand")
                break
        t = [each_ms(fn, 50) for fn in fns + fns]
        flat, per_sub = a.view(-1), a.view(-1, 1024)
        lib_flat = each_ms(lambda: torch.linalg.vector_norm(flat), 50)
        lib_sub = each_ms(lambda: torch.linalg.vector_norm(
            per_sub, dim=1, dtype=torch.float32), 50)
        print(f"sq_blocks{sfx} ({PLANE_W}, {rows}, 128), bound "
              f"{bound:.4f} ms: " + "; ".join(
                  f"{Path(s).name} {steady(t[i])} / "
                  f"{steady(t[i + len(fns)])}" for i, s in enumerate(srcs))
              + f" | vector_norm flat {steady(lib_flat)}, per sub-block "
              f"{steady(lib_sub)} | " + "; ".join(checks))
        del a, outs, fns, flat, per_sub
        torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--flash", nargs="*", default=[])
    ap.add_argument("--plane", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or not (args.flash or args.plane):
        print(__doc__, file=sys.stderr)
        return 2
    libs = {"bf16": [dataclasses.replace(
                fa.LIBRARY_BF16, name=f"flash_cmp_bf16_{i}",
                source=Path(s).resolve()) for i, s in enumerate(args.flash)],
            "f16": [dataclasses.replace(
                fa.LIBRARY_F16, name=f"flash_cmp_f16_{i}",
                source=Path(s).resolve()) for i, s in enumerate(args.flash)],
            "plane": [dataclasses.replace(
                fp.LIBRARY, name=f"fastpath_cmp_{i}",
                source=Path(s).resolve()) for i, s in enumerate(args.plane)]}
    build.build([lib for v in libs.values() for lib in v])
    print(gpu_name_and_power_limit())
    keep = {"bf16": ("flash_kernel",), "f16": ("flash_f16_kernel",
                                               "flash_kernel"),
            "plane": ("sq_kernel", "sq_half_kernel")}
    for kind, ls in libs.items():
        srcs = args.plane if kind == "plane" else args.flash
        for src, lib in zip(srcs, ls):
            for line in ptxas_lines(lib, keep[kind]):
                print(f"{kind} {src}: ptxas: {line}")
            for name, (total, ops) in sass_mix(lib.path(),
                                                keep[kind]).items():
                print(f"{kind} {src}: {name[:110]}: {total} instructions "
                      f"{ops}")
    dev = torch.device("cuda")
    bad = []
    if args.flash:
        flash_phase(args.flash, libs, dev, bad)
    if args.plane:
        from repro_torch.configs import get_config
        from repro_torch.dist.lag_trainer import param_layout
        rows = param_layout(get_config("llama3.2-1b")).rows
        sq_phase(args.plane, libs["plane"], dev, bad, rows)
    for b in bad:
        print(f"FAILED: {b}")
    print(f"flash_sq_compare: {'ok' if not bad else f'{len(bad)} failures'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
